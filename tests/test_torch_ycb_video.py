"""The port's YCB-Video bank and datasets against ``morefusion_tpu``.

The repository holds no YCB-Video data, so the tests write a small tree in
its layout: ``YCB_Video_Models`` with all 21 classes (box meshes, a bin,
and ``voxel_grid_to_mesh`` of a procedural model's solid grid; ``points.xyz``
for every other class) and ``YCB_Video_Dataset`` with ``image_sets``,
``data`` and ``data_syn`` frames rendered by the port's scene generator
at 96x128 and written with imageio: the label PNG holds class ids (a
class's second instance is left as background, as YCB-Video has one
instance a class), depth is uint16 at ``factor_depth`` 10000, one frame has
an alpha channel and one holds a single object (``loadmat`` squeezes its
``cls_indexes`` to a scalar and its ``poses`` to (3, 4)).

Everything here is host NumPy in both packages, so outputs must be equal
bit for bit: each frame through imageio and again with imageio hidden
(the port's cv2 path, the card machine's), each split and ``sampling``,
the ``IOError``s, the bank's getters and its npz cache, ``CadPointBank``
on the bank, the factory's examples and ``reindex`` of them. The factory
renders each instance's full model for its visibility, which needs the
bank's ``get_shape`` / ``get_surface_samples`` and ``get_color``:
``YCBVideoModels`` has neither in the JAX package, so there the factory
with its default bank raises ``AttributeError``, and the port keeps that
behaviour (tested); the factory runs with the procedural bank, as JAX's
own ``test_ycb_video_syn.py`` does. One narrow train step with the
occupancy term on the YCB bank is held to JAX's loss and gradients with
``test_torch_train.py``'s tolerances.
"""

import os
import shutil
import stat
import sys
from unittest import mock

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import scipy.io
import torch

from morefusion_tpu import datasets as JD
from morefusion_tpu import models as JM
from morefusion_tpu.extra import meshio as JMesh
from morefusion_tpu.models import losses as JL
from morefusion_tpu.training import trainer as JT
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.datasets.ycb_video import dataset as tdataset
from morefusion_tpu_torch.extra import meshio as TMesh
from morefusion_tpu_torch.extra import viz as TV
from morefusion_tpu_torch.training import trainer as TT
from tests.test_torch_model import _flax_to_np, torch_to_flax
from tests.test_torch_train import _jax_bank, _jax_exact_search

torch.set_num_threads(2)

SHAPE = (96, 128)
TRAIN_IDS = [f"0001/{k:06d}" for k in range(1, 7)]
KEYFRAME_IDS = ["0001/000002", "0001/000005"]
N_SYN = 2
SOLID_POINTS = 400  # the test bank's solid points a class (3000 to train)


def equal(got, want, what=""):
    """Dicts, lists or arrays equal bit for bit with equal dtypes."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            equal(got[k], want[k], f"{what}{k}:")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            equal(g, w, f"{what}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{what} {g.dtype} vs {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=what)


def procedural_voxel_mesh(class_id):
    """A procedural model's solid grid at half resolution as a box mesh."""
    grid = TD.ProceduralModels().get_solid_voxel_grid(class_id)
    idx = np.round((grid.points - grid.origin) / grid.pitch).astype(int) // 2
    occ = np.zeros(idx.max(axis=0) + 1, bool)
    occ[tuple(idx.T)] = True
    pitch = 2 * grid.pitch
    return TV.voxel_grid_to_mesh(occ, pitch,
                                 np.asarray(grid.origin) - grid.pitch / 2)


def write_models(root):
    rng = np.random.RandomState(0)
    names = TD.ycb_video.class_names
    for cid in range(1, 22):
        d = os.path.join(root, names[cid])
        os.makedirs(d)
        if cid == 14:
            v, f = procedural_voxel_mesh(cid)
        elif cid == 13:
            v, f = TMesh.bin_model((0.16, 0.12, 0.06), 0.01)
        else:
            v, f = TMesh.box_mesh(rng.uniform(0.03, 0.15, 3),
                                  rng.uniform(-0.01, 0.01, 3))
        TV.save_obj(os.path.join(d, "textured_simple.obj"), v, f)
        if cid % 2:
            pts = TMesh.sample_surface(v, f, 1000, np.random.RandomState(cid))
            np.savetxt(os.path.join(d, "points.xyz"), pts)


def write_frame(base, frame, max_objects=None, alpha=False):
    """One generator frame in YCB-Video's files (imageio, savemat)."""
    label = np.zeros(frame["depth"].shape, np.uint8)
    cls, poses = [], []
    for iid, cid, T in zip(frame["instance_ids"], frame["class_ids"],
                           frame["Ts_cad2cam"]):
        if cid in cls or (max_objects and len(cls) == max_objects):
            continue
        label[frame["instance_label"] == iid] = cid
        cls.append(int(cid))
        poses.append(T[:3, :4])
    depth = np.nan_to_num(frame["depth"] * 10000.0).round().astype(np.uint16)
    rgb = frame["rgb"]
    if alpha:
        rgb = np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])
    os.makedirs(os.path.dirname(base), exist_ok=True)
    imageio.imwrite(base + "-color.png", rgb)
    imageio.imwrite(base + "-depth.png", depth)
    imageio.imwrite(base + "-label.png", label)
    scipy.io.savemat(base + "-meta.mat", {
        "cls_indexes": np.asarray(cls, np.int32),
        "factor_depth": 10000.0,
        "intrinsic_matrix": frame["intrinsic_matrix"],
        "poses": np.stack(poses, axis=2),
    })


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ycb_video"))
    write_models(os.path.join(root, "YCB_Video_Models"))
    data = os.path.join(root, "YCB_Video_Dataset")
    gen = TD.SyntheticRGBDPoseEstimationDataset(
        n_frames=len(TRAIN_IDS) + N_SYN, n_objects=(2, 4), image_shape=SHAPE)
    for k, id_ in enumerate(TRAIN_IDS):
        write_frame(os.path.join(data, "data", id_), gen.get_frame(k),
                    max_objects=1 if k == 3 else None, alpha=k == 1)
    for k in range(N_SYN):
        write_frame(os.path.join(data, "data_syn", f"{k:06d}"),
                    gen.get_frame(len(TRAIN_IDS) + k))
    os.makedirs(os.path.join(data, "image_sets"))
    for split, ids in (("train", TRAIN_IDS), ("val", KEYFRAME_IDS),
                       ("trainval", TRAIN_IDS + KEYFRAME_IDS),
                       ("keyframe", KEYFRAME_IDS)):
        with open(os.path.join(data, "image_sets", f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return root


def models_dir(tree):
    return os.path.join(tree, "YCB_Video_Models")


def data_dir(tree):
    return os.path.join(tree, "YCB_Video_Dataset")


def no_imageio():
    """imageio cannot be imported (the card machine's case)."""
    return mock.patch.dict(sys.modules, {"imageio": None,
                                         "imageio.v2": None})


@pytest.mark.parametrize("reader", ["imageio", "cv2"])
def test_frames_match_jax(tree, reader):
    want = JD.YCBVideoDataset("trainval", root_dir=data_dir(tree))
    want = [want[i] for i in range(len(want))]
    got = TD.YCBVideoDataset("trainval", root_dir=data_dir(tree))
    if reader == "cv2":
        with no_imageio():
            assert TV.image_writer() == "cv2"
            got = [got[i] for i in range(len(got))]
    else:
        got = [got[i] for i in range(len(got))]
    equal(got, want)
    one = got[3]
    assert one["class_ids"].shape == (1,) and one["Ts_cad2cam"].shape == (
        1, 4, 4)
    assert got[1]["rgb"].shape == SHAPE + (3,)  # the alpha frame
    assert np.isnan(got[0]["depth"]).any()


@pytest.mark.parametrize("split,n", [("train", 6), ("val", 2),
                                     ("trainval", 8), ("keyframe", 2)])
def test_splits(tree, split, n):
    got = TD.YCBVideoDataset(split, root_dir=data_dir(tree))
    want = JD.YCBVideoDataset(split, root_dir=data_dir(tree))
    assert got.ids == want.ids and len(got) == n
    assert got.split == want.split == split
    assert got.root_dir == want.root_dir


def test_synthetic_split(tree):
    got = TD.YCBVideoSyntheticDataset(root_dir=data_dir(tree))
    want = JD.YCBVideoSyntheticDataset(root_dir=data_dir(tree))
    assert got.ids == want.ids == ["000000", "000001"]
    assert got.split == "syn"
    frames = [want[i] for i in range(N_SYN)]
    with no_imageio():
        equal([got[i] for i in range(N_SYN)], frames)


@pytest.mark.parametrize("split,sampling", [("train", 8), ("train", 3),
                                            ("train", 1), ("val", 8),
                                            ("syn", 8)])
def test_factory_examples_match_jax(tree, split, sampling):
    kw = dict(split=split, sampling=sampling, root_dir=data_dir(tree))
    got = TD.YCBVideoRGBDPoseEstimationDataset(
        models=TD.ProceduralModels(), **kw)
    want = JD.YCBVideoRGBDPoseEstimationDataset(
        models=JD.ProceduralModels(), **kw)
    assert got.ids == want.ids and got.split == want.split == split
    n = {"train": len(range(0, 6, sampling)), "val": 2, "syn": N_SYN}[split]
    assert len(got) == n
    for i in range(min(len(got), 2)):
        equal(got.get_frame(i), want.get_frame(i), f"frame {i}:")
    equal(got.get_example(0), want.get_example(0))


def test_factory_on_the_ycb_bank_raises_as_in_jax(tree):
    """The visibility render needs a shape or surface samples and a colour
    of each class, which neither package's ``YCBVideoModels`` has."""
    for pkg in (TD, JD):
        ds = pkg.YCBVideoRGBDPoseEstimationDataset(
            "train", models=pkg.YCBVideoModels(models_dir(tree)),
            root_dir=data_dir(tree))
        with pytest.raises(AttributeError):
            ds.get_example(0)


def test_io_errors(tmp_path):
    missing = str(tmp_path / "missing")
    for pkg in (TD, JD):
        with pytest.raises(IOError):
            pkg.YCBVideoDataset("train", root_dir=missing)
        with pytest.raises(IOError):
            pkg.YCBVideoSyntheticDataset(root_dir=str(tmp_path))
        with pytest.raises(IOError):
            pkg.YCBVideoModels(root_dir=missing)
    with mock.patch.dict(os.environ, {"MOREFUSION_TPU_DATA": missing}):
        with pytest.raises(IOError):
            TD.YCBVideoModels()
        with pytest.raises(IOError):
            TD.YCBVideoRGBDPoseEstimationDataset("train")
    with pytest.raises(ValueError):
        TD.YCBVideoDataset("test", root_dir=str(tmp_path))
    with pytest.raises(AttributeError):
        TD.NoSuchDataset  # noqa: B018


def test_lazy_exports():
    from morefusion_tpu_torch.datasets import ycb_video
    from morefusion_tpu_torch.datasets.ycb_video import models

    assert (TD.YCBVideoModels is ycb_video.YCBVideoModels
            is models.YCBVideoModels)
    assert TD.YCBVideoDataset is tdataset.YCBVideoDataset
    equal(ycb_video.class_ids_asymmetric, JD.ycb_video.class_ids_asymmetric)
    equal(ycb_video.class_names_asymmetric,
          JD.ycb_video.class_names_asymmetric)


@pytest.fixture(scope="module")
def banks(tree, tmp_path_factory):
    """Both packages' banks, each on its own copy of the tree (each writes
    its own npz cache)."""
    out = {}
    for name, pkg in (("torch", TD), ("jax", JD)):
        root = str(tmp_path_factory.mktemp(name) / "models")
        shutil.copytree(models_dir(tree), root)
        out[name] = pkg.YCBVideoModels(root)
    return out


def test_bank_getters_match_jax(banks):
    got, want = banks["torch"], banks["jax"]
    assert got.n_class == want.n_class == 22
    for cid in range(1, 22):
        assert got.get_cad_file(cid) != want.get_cad_file(cid)
        assert os.path.basename(got.get_cad_file(cid)) == "textured_simple.obj"
        equal(got.get_mesh(cid), want.get_mesh(cid), f"{cid} mesh")
        equal(got.get_pcd(cid), want.get_pcd(cid), f"{cid} pcd")
        g, w = got.get_solid_voxel_grid(cid), want.get_solid_voxel_grid(cid)
        equal([g.points, g.origin, g.inside_distance],
              [w.points, w.origin, w.inside_distance], f"{cid} grid")
        assert g.pitch == w.pitch
        equal(got.get_sdf(cid), want.get_sdf(cid), f"{cid} sdf")
        assert got.get_bbox_diagonal(cid) == want.get_bbox_diagonal(cid)
        assert (got.get_voxel_pitch(32, cid)
                == want.get_voxel_pitch(32, cid))


def test_npz_cache_written_read_and_optional(banks, tmp_path):
    src = banks["torch"].root_dir
    grid = banks["torch"].get_solid_voxel_grid(14)
    cache = os.path.join(src, "025_mug", "solid_voxels.npz")
    assert os.path.exists(cache)
    cached = TD.YCBVideoModels(src).get_solid_voxel_grid(14)
    equal([cached.points, cached.origin, cached.inside_distance],
          [grid.points, grid.origin, grid.inside_distance])
    assert cached.pitch == grid.pitch
    # a read-only directory: nothing is cached, the grid is the same
    ro = str(tmp_path / "ro")
    shutil.copytree(src, ro, ignore=shutil.ignore_patterns("*.npz"))
    class_dir = os.path.join(ro, "025_mug")
    os.chmod(class_dir, stat.S_IRUSR | stat.S_IXUSR)
    try:
        again = TD.YCBVideoModels(ro).get_solid_voxel_grid(14)
        writable = os.access(class_dir, os.W_OK)  # root ignores the mode
        assert os.path.exists(os.path.join(class_dir, "solid_voxels.npz")) \
            == writable
    finally:
        os.chmod(class_dir, stat.S_IRWXU)
    equal(again.points, grid.points)


def test_cad_point_bank_matches_jax(banks):
    got = TT.CadPointBank.build(banks["torch"], 21, device="cpu")
    want = JT.CadPointBank.build(banks["jax"], 21, with_solid=True)
    for name in ("points", "symmetric", "solid_points", "solid_sdf",
                 "solid_mask"):
        equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
              name)


def test_train_step_on_the_ycb_bank_matches_jax(tree, banks):
    """The tiny model's loss with the occupancy term and its gradients on
    two crops of the YCB frames, the bank built from the meshes (rtol 1e-4;
    each gradient within 1e-4 of its norm plus 1e-6 of the whole's)."""
    bank = TT.CadPointBank.build(banks["torch"], 21,
                                 max_solid_points=SOLID_POINTS, device="cpu")
    ds = TD.YCBVideoRGBDPoseEstimationDataset(
        "train", models=TD.ProceduralModels(), sampling=1,
        root_dir=data_dir(tree))
    examples = [e for i in range(len(ds)) for e in ds.get_example(i)][:2]
    rng = np.random.RandomState(0)
    batch = {k: np.stack([np.asarray(e[k]) for e in examples])
             for k in ("class_id", "rgb", "pcd", "quaternion_true",
                       "translation_true", "pitch", "origin",
                       "grid_target")}
    batch["class_id"] = batch["class_id"].astype(np.int32)
    batch["rgb"] = batch["rgb"].astype(np.float32)
    batch["grid_nontarget_empty"] = np.stack([
        np.maximum(e["grid_nontarget"], e["grid_empty"]) for e in examples])
    mask = ~np.isnan(batch["pcd"]).any(-1)
    batch["sample_indices"] = np.stack([
        rng.choice(np.flatnonzero(m.ravel()), 32, replace=False)
        for m in mask]).astype(np.int32)

    torch.manual_seed(0)
    model = TM.tiny_singleview3d(21, n_point=32, with_occupancy=True)
    loss, metrics = TT.make_loss_fn(model, bank)(batch, True, train=False)
    loss.backward()

    jmodel = JM.tiny_singleview3d(21, n_point=32, with_occupancy=True)
    jbank = _jax_bank(bank)
    cid = batch["class_id"]

    def jloss(params):
        quat, trans, conf = jmodel.apply(
            params, class_id=cid, rgb=batch["rgb"], pcd=batch["pcd"],
            pitch=batch["pitch"], origin=batch["origin"],
            grid_nontarget_empty=batch["grid_nontarget_empty"],
            sample_indices=batch["sample_indices"], train=False)
        add = JL.pose_loss(
            quaternion_pred=quat, translation_pred=trans,
            confidence_pred=conf,
            quaternion_true=batch["quaternion_true"],
            translation_true=batch["translation_true"],
            cad_points=jbank.points[cid], symmetric=jbank.symmetric[cid])
        occ = JL.occupancy_loss(
            quaternion_pred=quat, translation_pred=trans,
            confidence_pred=conf, solid_points=jbank.solid_points[cid],
            solid_sdf=jbank.solid_sdf[cid], solid_mask=jbank.solid_mask[cid],
            pitch=batch["pitch"], origin=batch["origin"],
            grid_target=batch["grid_target"],
            grid_nontarget_empty=batch["grid_nontarget_empty"])
        return add + occ, (add, occ)

    with _jax_exact_search():
        (jv, (jadd, jocc)), jgrads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(torch_to_flax(model))
    np.testing.assert_allclose(float(metrics["loss_add"].detach()),
                               float(jadd), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["loss_occupancy"].detach()),
                               float(jocc),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-4)
    assert float(metrics["loss_occupancy"]) != 0.0
    want = TM.params_from_jax(_flax_to_np(jgrads))
    total = float(torch.cat([g.reshape(-1) for g in want.values()]).norm())
    for name, p in model.named_parameters():
        err = float((p.grad - want[name]).norm())
        assert err <= 1e-4 * float(want[name].norm()) + 1e-6 * total, name


def test_reindex_matches_jax(tree, tmp_path):
    """``reindex`` of the train (every 2nd frame) and syn factories,
    through ``ConcatDataset``, with the C++ mapping on both sides."""
    def factory(pkg):
        kw = dict(models=pkg.ProceduralModels(), root_dir=data_dir(tree))
        return pkg.ConcatDataset(
            pkg.YCBVideoRGBDPoseEstimationDataset("train", sampling=2, **kw),
            pkg.YCBVideoRGBDPoseEstimationDataset("syn", **kw))

    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    with no_imageio():
        tmeta = TD.reindex(tdir, [factory(TD)], n_workers=1, progress=False)
    jmeta = JD.reindex(jdir, [factory(JD)], n_workers=1, progress=False)
    assert tmeta == jmeta and len(tmeta) >= 4
    for id_ in jmeta:
        with np.load(os.path.join(tdir, f"{id_}.npz")) as t, \
                np.load(os.path.join(jdir, f"{id_}.npz")) as j:
            equal(dict(t), dict(j), id_)


def test_meshio_of_the_tree_matches_jax(tree):
    path = os.path.join(models_dir(tree), "025_mug", "textured_simple.obj")
    v, f = TMesh.load_obj(path)
    equal((v, f), JMesh.load_obj(path))
    assert len(f) > 100  # the voxel mesh, faces split along diagonals
