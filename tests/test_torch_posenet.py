"""The port's PoseNet against ``morefusion_tpu.models.posenet`` on the CPU.

A narrow PoseNet (``backbone_width=8``, ``psp_bottleneck=32``,
``psp_up=(16, 8, 8)``, ``tower_widths=(32, 16, 8)``; the PoseNet tower's
own widths are fixed) initialised by flax once a module, its parameters
carried into the port by ``params_from_jax``:
- the forward with fixed ``sample_indices`` (centred and not): quaternion,
  translation and confidence within 1e-5;
- the train step's loss (``add/add_s``, one symmetric lane) through
  ``training.make_loss_fn``, which gives PoseNet neither ``pitch`` nor the
  occupancy grids of the batch, within 1e-5 relative of JAX's; gradients
  within ``test_torch_train.py``'s rule (``|g - g_jax| <= 1e-4 |g_jax| +
  1e-6 |G_jax|``, JAX's searches swapped for the exact argmin there);
- the parameters both ways: ``params_to_jax`` gives flax's tree back leaf
  for leaf and in order, and JAX reads the port's npz archive;
- ``cli.train --model posenet --device cpu`` at full width (64 points, so
  that ADD-S's plain search stays short), B = 2, one step and an
  evaluation on its inline set (made small here, before the CLI looks for
  it).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from morefusion_tpu import models as JM
from morefusion_tpu.models import losses as JL
from morefusion_tpu.training import checkpoints as JC
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.cli import train as cli
from morefusion_tpu_torch.training import checkpoints as TC
from morefusion_tpu_torch.training import trainer as TT
from tests.test_torch_model import _flax_to_np
from tests.test_torch_train import _batch, _jax_bank, _jax_exact_search

torch.set_num_threads(2)

N_POINT = 32
NARROW = dict(backbone_width=8, psp_bottleneck=32, psp_up=(16, 8, 8),
              tower_widths=(32, 16, 8))


def _forward_inputs(rng, B=2, S=64):
    b = _batch(rng, B=B, S=S, n_point=N_POINT)
    return {k: b[k] for k in ("class_id", "rgb", "pcd", "sample_indices")}


@pytest.fixture(scope="module")
def jax_params():
    """flax's init of the narrow PoseNet (21 classes), as numpy leaves."""
    kw = _forward_inputs(np.random.RandomState(1))
    jmodel = JM.PoseNet(n_fg_class=21, n_point=N_POINT, **NARROW)
    variables = jax.jit(lambda k: jmodel.init(k, **kw))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, variables)


def _port(variables, **kw):
    model = TM.PoseNet(n_fg_class=21, n_point=N_POINT, **NARROW, **kw)
    model.load_state_dict(TM.params_from_jax(_flax_to_np(variables)),
                          strict=True)
    return model


@pytest.mark.parametrize("centerize_pcd", [True, False])
def test_posenet_forward_matches_jax(rng, jax_params, centerize_pcd):
    kw = _forward_inputs(rng)
    jmodel = JM.PoseNet(n_fg_class=21, n_point=N_POINT,
                        centerize_pcd=centerize_pcd, **NARROW)
    jout = jax.jit(jmodel.apply)(jax_params, **kw)
    tmodel = _port(jax_params, centerize_pcd=centerize_pcd).eval()
    with torch.no_grad():
        tout = tmodel(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_posenet_feature_is_1408_wide_with_a_shared_global_part(rng):
    ext = TM.PoseNetExtractor()
    feat = ext(torch.rand(2, 7, 32), torch.rand(2, 7, 3))
    assert feat.shape == (2, 7, 1408)
    assert torch.equal(feat[:, :1, 384:].expand(-1, 7, -1), feat[:, :, 384:])


@pytest.fixture(scope="module")
def bank():
    return TT.CadPointBank.build(TD.ProceduralModels(), 21,
                                 max_solid_points=400, device="cpu")


def test_posenet_train_step_loss_and_grads_match_jax(rng, jax_params, bank):
    batch = _batch(rng, n_point=N_POINT)  # pitch and grids too: unused
    model = _port(jax_params)
    seen = {}
    forward = model.forward

    def spy(**kw):
        seen.update(kw)
        return forward(**kw)

    model.forward = spy
    loss, metrics = TT.make_loss_fn(model, bank)(batch, True, train=False)
    loss.backward()
    assert set(seen) == {"class_id", "rgb", "pcd", "sample_indices",
                         "generator", "train", "dropout_generator"}
    assert "loss_occupancy" not in metrics

    jmodel = JM.PoseNet(n_fg_class=21, n_point=N_POINT, **NARROW)
    jbank = _jax_bank(bank)
    cid = batch["class_id"]
    assert bool(jbank.symmetric[cid].any()) and not bool(
        jbank.symmetric[cid].all())

    def jloss(params):
        quat, trans, conf = jmodel.apply(
            params, class_id=cid, rgb=batch["rgb"], pcd=batch["pcd"],
            sample_indices=batch["sample_indices"], train=False)
        return JL.pose_loss(
            quaternion_pred=quat, translation_pred=trans,
            confidence_pred=conf,
            quaternion_true=batch["quaternion_true"],
            translation_true=batch["translation_true"],
            cad_points=jbank.points[cid], symmetric=jbank.symmetric[cid])

    jv = jax.jit(jloss)(jax_params)
    with _jax_exact_search():
        jgrads = jax.jit(jax.grad(jloss))(jax_params)
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)

    want = TM.params_from_jax(_flax_to_np(jgrads))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    total = float(torch.cat([g.reshape(-1) for g in want.values()]).norm())
    for name, p in got.items():
        err = float((p.grad - want[name]).norm())
        assert err <= 1e-4 * float(want[name].norm()) + 1e-6 * total, name


def test_posenet_parameters_both_ways(tmp_path, rng, jax_params):
    leaves = _flax_to_np(jax_params)
    model = _port(jax_params)
    back = TM.params_to_jax(model.state_dict())
    assert list(back) == list(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert [k for k in leaves if "['posenet_extractor']" in k] == [
        f"['params']['posenet_extractor']['Dense_{i}']['{leaf}']"
        for i in range(6) for leaf in ("bias", "kernel")]

    path = str(tmp_path / "posenet.npz")
    TC.export_params_npz(model, path)
    jvars = JC.import_params_npz(jax_params, path)
    loaded = TC.import_params_npz(
        TM.PoseNet(n_fg_class=21, n_point=N_POINT, **NARROW), path).eval()
    kw = _forward_inputs(rng)
    jout = jax.jit(JM.PoseNet(n_fg_class=21, n_point=N_POINT,
                              **NARROW).apply)(jvars, **kw)
    with torch.no_grad():
        tout = loaded(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_train_cli_posenet_one_step_and_an_evaluation(tmp_path):
    out = str(tmp_path / "run")
    for split, name in (("train", "data_train"), ("val", "data_val")):
        src = TD.SyntheticRGBDPoseEstimationDataset(
            split=split, n_frames=2, n_objects=(2, 3), image_shape=(120, 160))
        TD.reindex(os.path.join(out, name), [src], n_workers=1,
                   progress=False)
    n_val = len(TD.RGBDPoseEstimationDatasetReIndexed(
        os.path.join(out, "data_val"), split="val"))
    state, summary = cli.main([
        "--out", out, "--model", "posenet", "--device", "cpu",
        "--batch-size", "2", "--max-steps", "1", "--val-batch-size", "2",
        "--eval-interval", "0.01", "--min-visibility", "0", "--n-point",
        "64", "--tiny", "--bf16"])
    assert isinstance(state.model, TM.PoseNet)
    assert state.model.resnet_extractor.compute_dtype == torch.float32
    assert state.step == 1 and n_val >= 2 and state.model.n_point == 64
    assert np.isfinite(summary["main/add_or_add_s/auc"])
    with open(os.path.join(out, "args.json")) as f:
        assert json.load(f)["model"] == "posenet"
    for name in ("snapshot_trainer_latest",
                 "snapshot_model_best_validation_main_auc.npz"):
        assert os.path.isfile(os.path.join(out, name)), name
