"""The port's offline evaluation CLI against ``examples/evaluate.py``.

On the CPU at a small size: a packed val set of the port's generator (two
120x160 frames of 2-3 objects), a tiny occupancy model whose npz archive
(``export_params_npz`` of the port) both packages read, and the JAX script
run through ``runpy`` beside ``cli/evaluate.py --device cpu`` on the same
flags. Both read the run directory as it holds only ``args.json`` and the
best archive.

So that both see the same inputs and searches:
- the model's point sampling takes scores from a fixed permutation in both
  packages (``jax.random`` cannot be reproduced in torch);
- JAX's float32 nearest-point searches (``functions/loss.py::nn`` in ADD-S,
  ``tdf._scan_core`` in ICC's voxelization, ``contrib/icp.py``'s
  ``pairwise_sq_dist``) are patched to the exact sum, as
  ``test_torch_train.py`` and ``test_torch_icp.py`` patch them;
- ICC keeps 64 points an object in both (``max_points``; the script asks
  for 2048), so that the 5-iteration refines at 32^3 and 64^3 stay small.

Tolerances: raw ADD records within 1e-5 m; refined poses as
``test_torch_icc.py`` holds the refiner (poses within 1e-4 after its
iterations), carried into ADD as 2e-4 m, through ICP too. Two refines in a
row (``--icc-coarse-to-fine``, 5 iterations at 32^3 then 5 at 64^3) carry
a rounding difference of the first into a larger one of the second, as
they do in JAX alone: there each object's ADD is held within 2e-4 m plus
twice JAX's own spread when its starts move by 1e-7 m
(``test_torch_pipeline.py`` holds the pipeline's 30 iterations so).
"""

import contextlib
import json
import os
import runpy
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morefusion_tpu.contrib as jcontrib
import morefusion_tpu.training as jtraining
from morefusion_tpu.contrib import icp as jicp
from morefusion_tpu.functions import loss as jloss_module
from morefusion_tpu.functions import tdf as jtdf
from morefusion_tpu.models import singleview_3d as jsv3d
import morefusion_tpu_torch.contrib as tcontrib
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.cli import evaluate as cli
from morefusion_tpu_torch.models import singleview_3d as tsv3d
from morefusion_tpu_torch.training import checkpoints as TC
from tests.test_torch_icp import _exact_pairwise
from tests.test_torch_train import _exact_nn, _exact_scan_core

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
SHAPE = (120, 160)
ICC_POINTS = 64
RAW_ATOL = 1e-5
REFINED_ATOL = 2e-4
N_POINT = 32


def _scores(B, n):
    """Distinct sampling scores of each lane (exact in float32)."""
    return np.stack([np.random.RandomState(b).permutation(n)
                     for b in range(B)]).astype(np.float32)


def _jax_fixed_sampling(mask, key, n_point):
    B, H, W = mask.shape
    flat = mask.reshape(B, H * W)
    scores = jnp.where(flat, jnp.asarray(_scores(B, H * W)), -jnp.inf)
    _, idx = jax.lax.top_k(scores, n_point)
    slot = jnp.arange(n_point, dtype=jnp.int32)[None, :]
    nv = jnp.maximum(jnp.sum(flat, axis=1), 1)[:, None].astype(jnp.int32)
    wrapped = jnp.where(slot < nv, slot, slot % nv)
    return jnp.take_along_axis(idx, wrapped, axis=1).astype(jnp.int32)


def _torch_fixed_sampling(mask, n_point, generator=None):
    B, H, W = mask.shape
    flat = mask.reshape(B, H * W)
    scores = torch.from_numpy(_scores(B, H * W)).to(mask.device)
    scores = torch.where(flat, scores, float("-inf"))
    idx = torch.topk(scores, n_point, dim=1).indices
    n_valid = flat.sum(dim=1, keepdim=True).clamp_min(1)
    slot = torch.arange(n_point, device=mask.device)[None, :]
    return torch.gather(idx, 1, torch.where(slot < n_valid, slot,
                                            slot % n_valid))


def _fewer_points(cls):
    class Small(cls):
        def __init__(self, *args, **kw):
            kw["max_points"] = ICC_POINTS
            super().__init__(*args, **kw)
    return Small


def _built_once(create_train_state):
    """JAX's ``create_train_state`` built once per model configuration: the
    scripts use its parameters only as the template that ``restore_best``
    fills, every leaf, from the archive."""
    built = {}

    def create(model, *args, **kw):
        key = repr(model)
        if key not in built:
            built[key] = create_train_state(model, *args, **kw)
        return built[key]

    return create


@contextlib.contextmanager
def same_inputs():
    """Both packages on the same sampling, exact searches and ICC points.
    JAX's jitted functions are traced afresh inside (``jax.clear_caches``
    on the way in and out)."""
    jax.clear_caches()
    try:
        with mock.patch.object(jtraining, "create_train_state",
                               _built_once(jtraining.create_train_state)), \
                mock.patch.object(jsv3d, "sample_mask_indices",
                               _jax_fixed_sampling), \
                mock.patch.object(tsv3d, "sample_mask_indices",
                                  _torch_fixed_sampling), \
                mock.patch.object(jloss_module, "nn", _exact_nn), \
                mock.patch.object(jtdf, "_scan_core", _exact_scan_core), \
                mock.patch.object(jicp, "pairwise_sq_dist",
                                  _exact_pairwise), \
                mock.patch.object(
                    jcontrib, "IterativeCollisionCheck",
                    _fewer_points(jcontrib.IterativeCollisionCheck)), \
                mock.patch.object(
                    tcontrib, "IterativeCollisionCheck",
                    _fewer_points(tcontrib.IterativeCollisionCheck)):
            yield
    finally:
        jax.clear_caches()


def run_jax_script(name, argv):
    """``examples/<name>.py`` as a script with ``argv``."""
    with mock.patch.object(sys, "argv", [name + ".py"] + list(argv)):
        runpy.run_path(os.path.join(EXAMPLES, name + ".py"),
                       run_name="__main__")


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """Two frames of the port's generator, 2-3 objects each, packed."""
    root = tmp_path_factory.mktemp("eval_data")
    src = TD.SyntheticRGBDPoseEstimationDataset(
        split="val", n_frames=2, n_objects=(2, 3), image_shape=SHAPE)
    TD.reindex(str(root / "reindexed"), [src], n_workers=1, progress=False)
    TD.pack_reindexed(str(root / "reindexed"), str(root / "val_packed"),
                      progress=False)
    return str(root / "val_packed")


def write_run(path, with_occupancy=True, seed=0):
    """A run directory of ``args.json`` and a best archive: a seeded tiny
    model, exported by the port."""
    os.makedirs(path, exist_ok=True)
    torch.manual_seed(seed)
    model = TM.tiny_singleview3d(21, n_point=N_POINT,
                                 with_occupancy=with_occupancy)
    TC.export_params_npz(model, os.path.join(
        path, "snapshot_model_best_validation_main_auc.npz"))
    args = dict(tiny=True, n_point=N_POINT, with_occupancy=with_occupancy,
                loss="add/add_s")
    with open(os.path.join(path, "args.json"), "w") as f:
        json.dump(args, f)
    return path


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return write_run(str(tmp_path_factory.mktemp("runs") / "occ"))


@pytest.fixture(scope="module")
def patched():
    """``same_inputs`` for the whole module, so that its JAX script runs
    share their compiled functions."""
    with same_inputs():
        yield


def read(path):
    with open(path) as f:
        return json.load(f)


def compare_records(got, want, atol):
    """Per method: the same crops' classes, ADDs within ``atol`` (m)."""
    assert sorted(got) == sorted(want)
    for m in want:
        assert got[m]["class_id"] == want[m]["class_id"], m
        for k in ("add", "add_s", "add_or_add_s"):
            np.testing.assert_allclose(got[m][k], want[m][k], atol=atol(m),
                                       err_msg=f"{m} {k}")


def _atol(method):
    return RAW_ATOL if method in ("morefusion", "morefusion(host)") \
        else REFINED_ATOL


def _both(tmp_path, val_set, run_dir, flags):
    common = ["--log-dir", run_dir, "--data", val_set,
              "--batch-size", "4"] + flags
    run_jax_script("evaluate", common + ["--out", str(tmp_path / "jax.json")])
    summary, records, info = cli.main(
        common + ["--out", str(tmp_path / "torch.json"), "--device", "cpu"])
    return read(tmp_path / "torch.json"), read(tmp_path / "jax.json"), info


ALL_METHODS = ["morefusion", "morefusion+icp", "morefusion+icc",
               "morefusion+icc+icp"]


@pytest.mark.parametrize("methods,flags", [
    (ALL_METHODS, []),
    (["morefusion", "morefusion+icc"], [
        "--icc-cross-mode", "exact", "--grid-variant", "nontarget_full"]),
    (["morefusion+icc"], ["--icc-grid-scale", "2", "--icc-alpha-decay"]),
    (["morefusion+icc+icp"], ["--icc-protocol", "single", "--n-examples",
                              "2"]),
], ids=["four-methods", "exact-nontarget-full", "scale2-decay",
        "single-2-examples"])
def test_evaluate_records_match_jax(patched, tmp_path, val_set, run_dir,
                                    methods, flags):
    got, want, info = _both(
        tmp_path, val_set, run_dir,
        ["--methods"] + methods + flags
        + ["--icc-iterations", "5", "--icc-no-early-stop"])
    compare_records(got["records"], want["records"], _atol)
    assert set(got["records"]) == set(methods) | {"morefusion(host)"}
    for m, s in got.items():
        if m != "records":
            assert set(s) == set(want[m]), m
    assert info["n_frames"] >= 1 and info["refine_s"] > 0


def test_evaluate_reads_a_fit_run_and_defaults_to_cuda(tmp_path, val_set):
    """A run directory as ``fit`` leaves it (the torch snapshot beside its
    archive) gives the archive's weights; the device defaults to cuda."""
    assert cli.parse_args(["--log-dir", "a", "--data", "b"]).device == "cuda"
    from morefusion_tpu_torch.cli import _eval

    run = write_run(str(tmp_path / "run"), seed=3)
    model = TM.tiny_singleview3d(21, n_point=N_POINT, with_occupancy=True)
    TC.import_params_npz(model, os.path.join(
        run, "snapshot_model_best_validation_main_auc.npz"))
    torch.save(model.state_dict(),
               os.path.join(run, "snapshot_model_best_validation_main_auc"))
    os.remove(os.path.join(run, "snapshot_model_best_validation_main_auc"
                                ".npz"))
    loaded = _eval.restore(_eval.build_model(
        {"tiny": True, "n_point": N_POINT, "with_occupancy": True}, "cpu"),
        run)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


JITTER = 1e-7


def _jittered(cls, eps):
    """``cls`` with every start translation moved by ``eps`` (m)."""
    class Jittered(cls):
        def __init__(self, transforms, *args, **kw):
            transforms = [np.array(T, dtype=np.float64) for T in transforms]
            for T in transforms:
                T[:3, 3] += eps
            super().__init__(transforms, *args, **kw)
    return Jittered


def test_evaluate_coarse_to_fine_within_jax_spread(patched, tmp_path,
                                                   val_set, run_dir):
    flags = ["--methods", "morefusion+icc", "--icc-grid-scale", "2",
             "--icc-coarse-to-fine", "--icc-alpha-decay",
             "--icc-iterations", "5", "--icc-no-early-stop"]
    got, want, _ = _both(tmp_path, val_set, run_dir, flags)
    compare_records({"morefusion(host)": got["records"]["morefusion(host)"]},
                    {"morefusion(host)": want["records"]["morefusion(host)"]},
                    _atol)
    ref = np.array(want["records"]["morefusion+icc"]["add"])
    spread = np.zeros_like(ref)
    common = ["--log-dir", run_dir, "--data", val_set, "--batch-size", "4"]
    for k, eps in enumerate((JITTER, -JITTER)):
        out = str(tmp_path / f"jax_{k}.json")
        with mock.patch.object(
                jcontrib, "IterativeCollisionCheck",
                _jittered(jcontrib.IterativeCollisionCheck, eps)):
            run_jax_script("evaluate", common + flags + ["--out", out])
        spread = np.maximum(spread, np.abs(
            np.array(read(out)["records"]["morefusion+icc"]["add"]) - ref))
    gap = np.abs(np.array(got["records"]["morefusion+icc"]["add"]) - ref)
    assert np.all(gap <= REFINED_ATOL + 2 * spread), (gap, spread)
