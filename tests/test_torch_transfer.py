"""The port's single-buffer transfer form against the JAX package's.

``TransferSchema`` (its layout, ``pack`` bit for bit, ``unpack`` field by
field, also with raw fields at byte offsets that are not multiples of 4),
``reconstruct_pcd``, ``fit_pcd_coefs``, ``derive_transfer_arrays`` file for
file, ``PackedPoseDataset(transfer=True)`` and ``augment_mask_z`` against
``morefusion_tpu``, on a packed set of the port's generator; then ``fit``
on that set through the transfer path against JAX's ``fit`` with its mesh
cut to one device (the draws matched as in ``test_torch_parallel.py``).

Tolerances: everything packed, derived or drawn on the host is bit-equal.
XLA on the CPU fuses a multiply and an add into one rounding where torch
rounds twice, so: the unpacked rgb (YCrCb back to RGB in float32, a sum
of three products) within 1e-4 of 255; the unpacked depth
``zmin + (q - 1) scale`` within 2.4e-7 relative (two float32 ulps); the
rest of ``unpack`` exact; ``reconstruct_pcd`` rtol 1e-6 and atol 1e-7 m
(at the crop's centre ``a + b j`` nears 0, where the fused rounding moves
x by up to 7.5e-9 m); ``fit``'s losses rtol 1e-4, its AUCs atol 1e-4 and
its weights as ``test_torch_parallel.py`` holds them.
"""

import json
import os
import shutil
from unittest import mock

import jax
import numpy as np
import optax
import pytest
import torch

import morefusion_tpu.parallel as jparallel
from morefusion_tpu import datasets as JD
from morefusion_tpu import models as JM
from morefusion_tpu.datasets.rgbd_pose_estimation import (
    augmentation as jaug,
)
from morefusion_tpu.models import singleview_3d as jsv3d
from morefusion_tpu.training import loop as jloop
from morefusion_tpu.training import trainer as JT
from morefusion_tpu.training import transfer as JTr
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.datasets.rgbd_pose_estimation import (
    augmentation as taug,
)
from morefusion_tpu_torch.models import pspnet, singleview_3d
from morefusion_tpu_torch.training import loop as TLoop
from morefusion_tpu_torch.training import transfer as TTr
from tests import _torch_dp_worker as W
from tests.test_torch_model import _flax_to_np, torch_to_flax
from tests.test_torch_parallel import (
    PARAM_ATOL,
    NoDropout,
    jax_fixed_sampler,
)
from tests.test_torch_train import _jax_exact_search

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """Two frames of the port's generator (5 crops), packed, with the
    transfer arrays derived by the port."""
    root = tmp_path_factory.mktemp("transfer")
    src = TD.SyntheticRGBDPoseEstimationDataset(
        split="train", n_frames=2, n_objects=(2, 3), image_shape=(120, 160))
    TD.reindex(str(root / "reindexed"), [src], n_workers=1, progress=False)
    TD.pack_reindexed(str(root / "reindexed"), str(root / "packed"),
                      progress=False)
    path = str(root / "packed")
    TD.derive_transfer_arrays(path, progress=False)
    return path


def _batch(packed, idx=(0, 2, 4)):
    ds = TD.PackedPoseDataset(packed, augmentation=True, transfer=True)
    return TD.Transform(True, True, seed=1).batch(ds.load_batch(list(idx)))


def test_derive_transfer_arrays_equals_jax_file_for_file(packed, tmp_path):
    for name in ("jax", "port"):
        shutil.copytree(packed, tmp_path / name, ignore=shutil.ignore_patterns(
            "z16.npy", "pcd_coef.npy"))
        assert not TD.has_transfer_arrays(str(tmp_path / name))
    want = JD.derive_transfer_arrays(str(tmp_path / "jax"), progress=False)
    got = TD.derive_transfer_arrays(str(tmp_path / "port"), progress=False)
    np.testing.assert_array_equal(got, want)
    for f in ("z16.npy", "pcd_coef.npy"):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f
    assert JD.has_transfer_arrays(str(tmp_path / "port"))


def test_fit_pcd_coefs_and_reconstruct_pcd_match_jax(packed):
    pcd = np.load(os.path.join(packed, "pcd.npy"))
    coef = TTr.fit_pcd_coefs(pcd)
    np.testing.assert_array_equal(coef, JTr.fit_pcd_coefs(pcd))
    z = np.load(os.path.join(packed, "z16.npy"))
    want = np.asarray(jax.jit(JTr.reconstruct_pcd)(z, coef))
    got = TTr.reconstruct_pcd(torch.from_numpy(z), torch.from_numpy(coef))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_mask_z_matches_jax(packed, seed):
    ds = TD.PackedPoseDataset(packed, transfer=True)
    b = ds.load_batch([seed % len(ds)])
    args = (b["rgb"][0], b["z"][0], b["pcd_coef"][0])
    got = taug.augment_mask_z(*args, np.random.RandomState(seed))
    want = jaug.augment_mask_z(*args, np.random.RandomState(seed))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_packed_transfer_dataset_matches_jax(packed):
    kw = dict(augmentation=True, transfer=True, seed=4)
    got = TD.PackedPoseDataset(packed, **kw)
    want = JD.PackedPoseDataset(packed, **kw)
    for idx in ([0, 2, 4], [1, 3]):
        g, w = got.load_batch(idx), want.load_batch(idx)
        assert sorted(g) == sorted(w) and "pcd" not in g
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    g, w = got.get_example(2), want.get_example(2)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_pack_is_jax_bit_for_bit(packed):
    batch = _batch(packed)
    got, want = TTr.TransferSchema(batch), JTr.TransferSchema(batch)
    assert got.fields == want.fields and got.row_bytes == want.row_bytes
    assert [f[1] for f in got.fields] == [
        "yuv420", "q8", "raw", "bits", "bits", "raw", "raw", "raw", "raw",
        "raw"]
    buf = got.pack(batch)
    assert buf.dtype == np.uint8 and buf.shape == (3, got.row_bytes)
    np.testing.assert_array_equal(buf, want.pack(batch))
    with pytest.raises(ValueError, match="_CANONICAL"):
        TTr.TransferSchema(dict(batch, extra=batch["pitch"]))


def _unpack_both(batch):
    schema = TTr.TransferSchema(batch)
    buf = schema.pack(batch)
    jschema = JTr.TransferSchema(batch)
    want = jax.device_get(jax.jit(jschema.unpack)(buf))
    got = schema.unpack(torch.from_numpy(buf))
    assert sorted(got) == sorted(want)
    return schema, got, want


def test_unpack_matches_jax_field_by_field(packed):
    batch = _batch(packed)
    _, got, want = _unpack_both(batch)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "rgb":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * 255)
        elif k == "z":
            np.testing.assert_allclose(g, w, rtol=2.4e-7, atol=0)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for k in ("grid_target", "grid_nontarget_empty", "class_id", "pitch",
              "quaternion_true", "translation_true", "origin", "pcd_coef"):
        np.testing.assert_array_equal(got[k].numpy(), batch[k], err_msg=k)


def test_unpack_of_raw_fields_at_unaligned_offsets(rng):
    """rgb of an odd shape ships raw (105 bytes), so the float and int
    fields after it start at offsets 105, 121, 125, 137: none a multiple
    of their item size."""
    B = 3
    batch = dict(
        rgb=rng.randint(0, 256, (B, 5, 7, 3)).astype(np.uint8),
        pcd_coef=rng.normal(size=(B, 4)).astype(np.float32),
        class_id=rng.randint(1, 22, B).astype(np.int32),
        quaternion_true=rng.normal(size=(B, 3)).astype(np.float32),
        pitch=rng.uniform(size=B).astype(np.float32),
    )
    schema, got, want = _unpack_both(batch)
    offsets = [f[4] for f in schema.fields]
    assert offsets == [0, 105, 121, 125, 137]
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), batch[k], err_msg=k)


def test_packed_transfer_form_needs_its_arrays(packed, tmp_path):
    plain = tmp_path / "plain"
    shutil.copytree(packed, plain, ignore=shutil.ignore_patterns(
        "z16.npy", "pcd_coef.npy"))
    for pkg in (TD, JD):
        with pytest.raises(IOError, match="derive_transfer_arrays"):
            pkg.PackedPoseDataset(str(plain), transfer=True)


def test_fit_takes_the_transfer_path_as_jax(packed, tmp_path):
    torch.manual_seed(0)
    model = TM.tiny_singleview3d(21, n_point=32, with_occupancy=True)
    start = {k: v.detach().clone().numpy()
             for k, v in model.named_parameters()}
    jmodel = NoDropout(JM.tiny_singleview3d(21, n_point=32,
                                            with_occupancy=True))
    params = torch_to_flax(model)

    def create(m, example, rng, learning_rate, with_occupancy=False):
        return JT.TrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=optax.adam(learning_rate))

    common = dict(batch_size=2, epochs=2, eval_interval=1.0, log_interval=1,
                  val_batch_size=4, n_fg_class=21)
    one = jparallel.data_mesh
    out = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    with mock.patch.object(jsv3d, "sample_mask_indices", jax_fixed_sampler), \
            _jax_exact_search(), \
            mock.patch.object(jloop, "create_train_state", create), \
            mock.patch.object(jparallel, "data_mesh",
                              lambda: one(jax.devices()[:1])):
        jstate, jsummary = jloop.fit(
            model=jmodel, models_bank=JD.ProceduralModels(),
            train_dataset=JD.PackedPoseDataset(packed, augmentation=True,
                                               transfer=True),
            val_dataset=JD.PackedPoseDataset(packed, split="val",
                                             transfer=True),
            out_dir=out["jax"], transform_train=JD.Transform(True, True),
            transform_val=JD.Transform(False, True), with_occupancy=True,
            **common)

    schemas = []
    real = TLoop.make_dp_train_step

    def spy(*args, **kw):
        schemas.append(kw["transfer_schema"])
        return real(*args, **kw)

    with mock.patch.object(singleview_3d, "sample_mask_indices",
                           W.torch_fixed_sampler), \
            mock.patch.object(pspnet, "dropout", W.no_dropout), \
            mock.patch.object(TLoop, "BatchLoader", W.OffsetLoader), \
            mock.patch.object(TLoop, "make_dp_train_step", spy):
        state, summary = TLoop.fit(
            model=model, models_bank=TD.ProceduralModels(),
            train_dataset=TD.PackedPoseDataset(packed, augmentation=True,
                                               transfer=True),
            val_dataset=TD.PackedPoseDataset(packed, split="val",
                                             transfer=True),
            out_dir=out["port"], transform_train=TD.Transform(True, True),
            transform_val=TD.Transform(False, True), device="cpu", **common)
    assert len(schemas) == 1 and isinstance(schemas[0], TTr.TransferSchema)
    with open(os.path.join(out["port"], "timing.json")) as f:
        timing = json.load(f)
    assert timing["batch_bytes"] == 2 * schemas[0].row_bytes
    assert len(timing["pack_ms"]) == state.step == 4

    logs = {}
    for k, d in out.items():
        with open(os.path.join(d, "log.json")) as f:
            logs[k] = json.load(f)
    assert ([r["iteration"] for r in logs["port"]]
            == [r["iteration"] for r in logs["jax"]])
    for g, w in zip(logs["port"], logs["jax"]):
        for k in w:
            if k.startswith("main/loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            elif "auc" in k:
                np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=k)
    assert sorted(summary) == sorted(jsummary)
    want = TM.params_from_jax(_flax_to_np(jstate.params))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        update = np.abs(w - start[name]).max()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=PARAM_ATOL * update + 1e-8,
                                   err_msg=name)
