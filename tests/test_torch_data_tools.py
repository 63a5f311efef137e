"""The port's data and campaign tools against their ``examples/`` scripts.

Each CLI runs beside its JAX script (through ``runpy``) on the same inputs,
and their outputs must be equal: ``compute_voxel_size``'s CSV (the
procedural bank and ``--ycb-video`` on a tree of box meshes),
``visualize_data``'s OBJ text and PNG pixels, ``ambiguity_floor``'s JSON
at 40 rotations, ``plot_curves``' markdown table on the committed occ and
noocc logs (its PNG only exists), ``resolution_ab``'s JSON on the committed
r5tex and r5hires logs, and ``export_checkpoint``'s archive of a tiny run,
entry for entry (it also equals the run's own best archive).
``regen_datasets``' fingerprint checks run in both packages on a small
generated set and its textured twin, and on copies whose scalars are
changed: both accept and both refuse the same sets. ``campaign_guardian``
polls a run and banks its best archive in a temporary git repository,
as the JAX script does in another.
"""

import json
import os
import runpy
import shutil
import subprocess
import sys
from unittest import mock

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch import training as TT
from morefusion_tpu_torch.cli import ambiguity_floor
from morefusion_tpu_torch.cli import campaign_guardian
from morefusion_tpu_torch.cli import compute_voxel_size
from morefusion_tpu_torch.cli import export_checkpoint
from morefusion_tpu_torch.cli import generate_data
from morefusion_tpu_torch.cli import plot_curves
from morefusion_tpu_torch.cli import regen_datasets
from morefusion_tpu_torch.cli import resolution_ab
from morefusion_tpu_torch.cli import visualize_data
from morefusion_tpu_torch.extra import meshio as TMesh
from morefusion_tpu_torch.extra import viz as TV

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
RESULTS = os.path.join(ROOT, "docs", "results")


def run_example(name, argv):
    with mock.patch.object(sys, "argv", [name + ".py"] + list(argv)):
        runpy.run_path(os.path.join(EXAMPLES, name + ".py"),
                       run_name="__main__")


def example_module(name):
    """The script's functions (its globals are the functions' own)."""
    return runpy.run_path(os.path.join(EXAMPLES, name + ".py"))


def read(path):
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def box_bank(tmp_path_factory):
    """A data root with ``ycb_video/YCB_Video_Models`` of box meshes."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(1)
    for cid in range(1, 22):
        d = root / "ycb_video" / "YCB_Video_Models" / str(
            TD.ycb_video.class_names[cid])
        os.makedirs(d)
        TV.save_obj(str(d / "textured_simple.obj"),
                    *TMesh.box_mesh(rng.uniform(0.03, 0.2, 3)))
    return str(root)


@pytest.mark.parametrize("ycb", [False, True])
def test_compute_voxel_size_matches_example(tmp_path, box_bank, ycb):
    flags = ["--voxel-dim", "24"] + (["--ycb-video"] if ycb else [])
    with mock.patch.dict(os.environ, {"MOREFUSION_TPU_DATA": box_bank}):
        rows = compute_voxel_size.main(flags + ["--out",
                                                str(tmp_path / "t.csv")])
        run_example("preliminary/compute_voxel_size",
                    flags + ["--out", str(tmp_path / "j.csv")])
    assert read(tmp_path / "t.csv") == read(tmp_path / "j.csv")
    assert len(rows) == 21


def test_visualize_data_matches_example(tmp_path):
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    got = visualize_data.main(["--out", str(out_t), "--frame", "1",
                               "--voxel-dim", "16"])
    run_example("preliminary/visualize_data",
                ["--out", str(out_j), "--frame", "1", "--voxel-dim", "16"])
    assert read(got["obj"]) == read(out_j / "grid_target.obj")
    assert got["n_vertices"] > 0
    png = imageio.imread(got["png"])
    assert png.ndim == 3 and png.shape[2] == 3
    np.testing.assert_array_equal(png, imageio.imread(out_j / "frame.png"))


def test_ambiguity_floor_matches_example(tmp_path):
    flags = ["--artifact", os.path.join(RESULTS,
                                        "r4_refine_table_joint.json"),
             "--n-rotations", "40", "--n-points", "64"]
    got = ambiguity_floor.main(flags + ["--out", str(tmp_path / "t.json")])
    run_example("ambiguity_floor", flags + ["--out",
                                            str(tmp_path / "j.json")])
    assert read(tmp_path / "t.json") == read(tmp_path / "j.json")
    assert got["summary"]["n_classes"] == len(got["classes"]) > 10


def test_plot_curves_matches_example(tmp_path, capsys):
    runs = tmp_path / "runs"
    for name in ("occ", "noocc"):
        os.makedirs(runs / name)
        shutil.copy(os.path.join(RESULTS, f"{name}_log.json"),
                    runs / name / "log.json")
    lines = plot_curves.main(["--runs", str(runs), "--out",
                              str(tmp_path / "t.png")])
    got = capsys.readouterr().out
    run_example("plot_curves", ["--runs", str(runs), "--out",
                                str(tmp_path / "j.png")])
    want = capsys.readouterr().out
    assert got.replace("t.png", "j.png") == want
    assert len(lines) > 3 and os.path.getsize(tmp_path / "t.png") > 0


def test_resolution_ab_matches_example(tmp_path):
    for tag in ("r5tex", "r5hires"):
        os.makedirs(tmp_path / tag)
        shutil.copy(os.path.join(RESULTS, f"{tag}_log.json"),
                    tmp_path / tag / "log.json")
    flags = ["--a", str(tmp_path / "r5tex"), "--b", str(tmp_path / "r5hires")]
    rec = resolution_ab.main(flags + ["--out", str(tmp_path / "t.json")])
    run_example("resolution_ab", flags + ["--out", str(tmp_path / "j.json")])
    assert read(tmp_path / "t.json") == read(tmp_path / "j.json")
    assert rec["matched_epochs"]


def test_export_checkpoint_matches_example(tmp_path):
    run = tmp_path / "run"
    torch.manual_seed(0)
    model = TM.tiny_singleview3d(21, n_point=32, with_occupancy=True)
    TT.CheckpointManager(str(run)).save_best(model, "validation/main/auc",
                                             0.5)
    TT.write_args(str(run), dict(tiny=True, n_point=32, with_occupancy=True,
                                 loss="add/add_s"))
    out = export_checkpoint.main(["--log-dir", str(run), "--out",
                                  str(tmp_path / "t.npz"), "--device", "cpu"])
    run_example("export_checkpoint", ["--log-dir", str(run), "--out",
                                      str(tmp_path / "j.npz")])
    own = run / "snapshot_model_best_validation_main_auc.npz"
    with np.load(out) as t, np.load(tmp_path / "j.npz") as j, \
            np.load(own) as o:
        assert sorted(t.files) == sorted(j.files) == sorted(o.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            np.testing.assert_array_equal(t[k], o[k], err_msg=k)
    with pytest.raises(SystemExit):
        export_checkpoint.main(["--log-dir", str(run), "--metric", "nope",
                                "--out", str(tmp_path / "x.npz"),
                                "--device", "cpu"])


@pytest.fixture(scope="module")
def twin_sets(tmp_path_factory):
    """A 2-frame val set and its textured twin, packed."""
    root = tmp_path_factory.mktemp("regen")
    flags = ["--split", "val", "--n-frames", "2", "--n-objects", "2", "3",
             "--seed", "1", "--settle", "drop", "--image-shape", "96", "128"]
    out = {}
    for name, extra in (("plain", []), ("tex", ["--textured"])):
        reindexed = str(root / f"{name}_reindexed")
        generate_data.main(flags + extra + ["--out", reindexed])
        out[name] = str(root / f"{name}_packed")
        TD.pack_reindexed(reindexed, out[name], progress=False)
    return out


def test_regen_fingerprints_match_example(twin_sets, tmp_path):
    jax_regen = example_module("synthetic/regen_datasets")
    plain, tex = twin_sets["plain"], twin_sets["tex"]
    for k, v in regen_datasets.packed_scalars(plain).items():
        np.testing.assert_array_equal(
            v, jax_regen["packed_scalars"](plain)[k])
    # the textured twin passes both, a changed copy fails both
    regen_datasets.verify_scene_identity(tex, plain)
    jax_regen["verify_scene_identity"](tex, plain)
    bad = shutil.copytree(tex, tmp_path / "bad")
    scalars = dict(np.load(bad / "scalars.npz"))
    scalars["pitch"] = scalars["pitch"] * 1.001
    np.savez(bad / "scalars.npz", **scalars)
    with pytest.raises(regen_datasets.FingerprintError, match="pitch"):
        regen_datasets.verify_scene_identity(str(bad), plain)
    with pytest.raises(AssertionError, match="pitch"):
        jax_regen["verify_scene_identity"](str(bad), plain)
    # a 2-frame set is not the committed 862-crop hard val set, nor the
    # 870-crop hires one
    for fn in ("verify_hard_val", "verify_hires_val"):
        args = (plain,) if fn == "verify_hard_val" else (tex, plain)
        with pytest.raises(regen_datasets.FingerprintError):
            getattr(regen_datasets, fn)(*args)
        with pytest.raises(AssertionError):
            jax_regen[fn](*args)


def _git(repo, *args):
    return subprocess.run(["git", *args], cwd=repo, check=True,
                          capture_output=True, text=True).stdout


def _git_repo(path):
    os.makedirs(path / "docs" / "results")
    _git(path, "init", "-q")
    _git(path, "config", "user.email", "guardian@example.com")
    _git(path, "config", "user.name", "guardian")
    (path / "README").write_text("x\n")
    _git(path, "add", "README")
    _git(path, "commit", "-q", "-m", "init")
    return path


def test_campaign_guardian_banks_as_the_example(tmp_path):
    run = tmp_path / "run"
    os.makedirs(run)
    rows = [dict(epoch=0.5, iteration=5, **{"main/loss": 1.0}),
            dict(epoch=1.0, iteration=10, **{"main/add_or_add_s/auc": 0.41}),
            dict(epoch=2.0, iteration=20, **{"main/add_or_add_s/auc": 0.47})]
    (run / "log.json").write_text(json.dumps(rows))
    (run / "args.json").write_text(json.dumps(dict(tiny=True)))
    np.savez(run / "snapshot_model_best_validation_main_auc.npz",
             a=np.arange(3))
    done = subprocess.Popen(["true"])
    done.wait()
    argv = ["--run-dir", str(run), "--tag", "r9", "--pid", str(done.pid),
            "--interval", "0"]
    assert campaign_guardian.best_val_auc(str(run)) == (0.47, rows[2])
    assert campaign_guardian.best_val_auc(str(tmp_path)) == (None, None)

    logs = {}
    jax_guardian = example_module("campaign_guardian")
    for name, main, namespace in (
            ("torch", campaign_guardian.main, vars(campaign_guardian)),
            ("jax", jax_guardian["main"], jax_guardian["main"].__globals__)):
        repo = _git_repo(tmp_path / name)
        with mock.patch.dict(namespace, {
                "REPO": str(repo),
                "RESULTS": str(repo / "docs" / "results")}), \
                mock.patch.object(sys, "argv", ["guardian.py"] + argv):
            banked = main(argv) if name == "torch" else main()
        logs[name] = (_git(repo, "log", "--format=%s", "--name-only"),
                      read(repo / "docs" / "results" / "r9_log.json"))
        if name == "torch":
            assert banked == 0.47
    assert logs["torch"] == logs["jax"]
    assert "r9_best_bf16.npz" in logs["torch"][0]
    assert "AUC 0.4700, epoch 2.0" in logs["torch"][0]
