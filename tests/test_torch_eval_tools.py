"""The port's evaluation tools against their ``examples/`` scripts:
``cli/eval_sweep.py``, ``cli/ablation_report.py``, ``cli/icc_diagnose.py``
and ``cli/check_icp_vs_icc.py``.

On the CPU, with the inputs, patches and tolerances of
``test_torch_evaluate.py`` (the same val set, tiny models, sampling, exact
searches and 64 ICC points an object). JAX's sweep and diagnosis build the
full-width model whatever the run's ``args.json`` says; here they build the
tiny one the run was written with, as the port does.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import morefusion_tpu.metrics as jmetrics
import morefusion_tpu.models as JM
from morefusion_tpu_torch.cli import ablation_report
from morefusion_tpu_torch.cli import check_icp_vs_icc
from morefusion_tpu_torch.cli import eval_sweep
from morefusion_tpu_torch.cli import icc_diagnose
from tests.test_torch_evaluate import (  # noqa: F401  (fixtures)
    RAW_ATOL, REFINED_ATOL, read, run_jax_script, same_inputs, val_set,
    write_run)

torch.set_num_threads(2)

LOSS_ATOL = 1e-5  # the ICC loss and its parts, as test_torch_icc_modes.py


_JAX_SINGLEVIEW3D = JM.SingleView3D


def _tiny_jax(**kw):
    """``models.tiny_singleview3d``'s widths, on the class it patches."""
    return _JAX_SINGLEVIEW3D(
        **kw, backbone_width=8, psp_bottleneck=64, psp_up=(32, 16, 16),
        conv3_channels=32, conv4_channels=64, tower_widths=(64, 32, 16))


@pytest.fixture(scope="module")
def patched():
    with same_inputs(), mock.patch.object(JM, "SingleView3D", _tiny_jax):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    write_run(str(root / "occ"), with_occupancy=True, seed=0)
    write_run(str(root / "noocc"), with_occupancy=False, seed=1)
    return str(root)


SWEEP = ("occ:observed", "occ:nontarget_full", "occ:full_bg",
         "noocc:observed")


@pytest.fixture(scope="module")
def sweeps(patched, runs, val_set, tmp_path_factory):
    """Both sweeps' output directories."""
    out = {}
    entries = [f"{e}:{val_set}" for e in SWEEP]
    for who in ("jax", "torch"):
        out[who] = str(tmp_path_factory.mktemp(f"sweep_{who}"))
        argv = ["--runs-root", runs, "--out-dir", out[who], "--batch-size",
                "4", "--sweep"] + entries
        if who == "jax":
            run_jax_script("eval_sweep", argv)
        else:
            eval_sweep.main(argv + ["--device", "cpu"])
    return out


@pytest.mark.parametrize("entry", SWEEP)
def test_eval_sweep_matches_jax(sweeps, entry):
    name = "eval_{}_{}.json".format(*entry.split(":"))
    got = read(os.path.join(sweeps["torch"], name))
    want = read(os.path.join(sweeps["jax"], name))
    assert got["records"]["class_id"] == want["records"]["class_id"]
    assert len(got["records"]["class_id"]) == 5
    for k in ("add", "add_s", "add_or_add_s"):
        np.testing.assert_allclose(got["records"][k], want["records"][k],
                                   atol=RAW_ATOL)
    assert set(got["morefusion"]) == set(want["morefusion"])


def test_eval_sweep_names_other_datasets(patched, runs, val_set, tmp_path):
    other = str(tmp_path / "easyval_packed")
    os.symlink(val_set, other)
    eval_sweep.main(["--runs-root", runs, "--out-dir", str(tmp_path),
                     "--sweep", f"noocc:observed:{other}", "--device",
                     "cpu", "--batch-size", "8"])
    assert os.path.isfile(tmp_path / "eval_noocc_observed_easyval_packed"
                                     ".json")


def _report(capsys, runner, runs_dir):
    argv = ["--runs", runs_dir, "--n-boot", "50"]
    runner(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_ablation_report_equals_jax(capsys, sweeps, which):
    """The port's report on a sweep's files prints JAX's report on them,
    character for character: the 4-row table and the paired bootstrap."""
    want = _report(capsys, lambda a: run_jax_script("ablation_report", a),
                   sweeps[which])
    got = _report(capsys, ablation_report.main, sweeps[which])
    assert got == want
    assert "| MF+target-+bg (full grids) | " in got
    assert "missing" not in got
    assert "Paired bootstrap (n=50" in got


def test_ablation_report_tables_close(capsys, sweeps):
    """The port's sweep gives JAX's table, to the printed digits."""
    got = _report(capsys, ablation_report.main, sweeps["torch"])
    want = _report(capsys, ablation_report.main, sweeps["jax"])
    assert got.split("\n\n")[0] == want.split("\n\n")[0]


@pytest.mark.parametrize("flags", [
    ["--icc-cross-mode", "exact"],
    ["--perturb-t", "0.01", "--perturb-r", "5", "--alpha-decay",
     "--grid-variant", "nontarget_full"],
], ids=["exact", "perturbed-decay-nontarget-full"])
def test_icc_diagnose_matches_jax(patched, runs, val_set, tmp_path, flags):
    argv = ["--log-dir", os.path.join(runs, "occ"), "--data", val_set,
            "--n-frames", "2", "--iterations", "5", "--no-early-stop"]
    argv += flags
    run_jax_script("icc_diagnose", argv + ["--out",
                                           str(tmp_path / "jax.json")])
    summary, rows = icc_diagnose.main(
        argv + ["--out", str(tmp_path / "torch.json"), "--device", "cpu"])
    got, want = read(tmp_path / "torch.json"), read(tmp_path / "jax.json")
    assert set(got["summary"]) == set(want["summary"])
    assert len(got["frames"]) == len(want["frames"]) == 2
    for g, w in zip(got["frames"], want["frames"]):
        assert (g["frame"], g["n_objects"], g["n_iter"]) == (
            w["frame"], w["n_objects"], w["n_iter"])
        for k in ("loss_pred", "loss_gt", "penalty_pred", "penalty_gt",
                  "reward_pred", "reward_gt"):
            np.testing.assert_allclose(g[k], w[k], atol=LOSS_ATOL,
                                       err_msg=k)
        np.testing.assert_allclose(g["add_pred"], w["add_pred"],
                                   atol=RAW_ATOL)
        np.testing.assert_allclose(g["add_refined"], w["add_refined"],
                                   atol=REFINED_ATOL)
        for k in ("loss_refined", "penalty_refined", "reward_refined"):
            # at the refined poses: the refiner's pose tolerance carried in
            np.testing.assert_allclose(g[k], w[k], atol=1e-3, err_msg=k)


def test_check_icp_vs_icc_matches_jax(patched):
    """The chain of ``check_icp_vs_icc`` from the same perturbed starts on
    one scene of 3 objects: every object's ADD per method as JAX's. JAX's
    script prints only means, so its ADDs are taken from its calls of
    ``metrics.average_distance`` (one call an object, in its order)."""
    argv = ["--n-scenes", "1", "--n-objects", "3", "--seed", "1"]
    calls = []
    real = jmetrics.average_distance

    def recorded(*a, **kw):
        out = real(*a, **kw)
        calls.append(float(out[0][0]))
        return out

    with mock.patch.object(jmetrics, "average_distance", recorded):
        run_jax_script("check_icp_vs_icc", argv)
    errors, iters = check_icp_vs_icc.main(argv + ["--device", "cpu"])
    n = len(errors["init"])
    assert n == 3 and len(calls) == 5 * n
    want = dict(zip(errors, np.reshape(calls, (5, n))))
    for method, adds in errors.items():
        atol = RAW_ATOL if method == "init" else REFINED_ATOL
        np.testing.assert_allclose(adds, want[method], atol=atol,
                                   err_msg=method)
    assert all(len(v) == 1 and 0 < v[0] <= 30 for v in iters.values())
