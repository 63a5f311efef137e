"""The port's segmenter against ``morefusion_tpu.models.segmentation``.

The UNet (weights carried across by ``variables_from_jax``) gives JAX's
logits within 1e-5, with and without the boundary head and the depth
channel. The host helpers are copies and give JAX's results on the JAX
tests' own inputs. ``connected_components`` gives JAX's keys exactly, on
the cases of ``tests/ops_tests/test_connected_components.py`` and at a
``max_iters`` that cuts the propagation short. ``SegmentationNode`` gives
JAX's labels and classes in both instancing modes, and the scene pipeline
with the segmenter (a tiny SingleView3D at a 16^3 grid) gives JAX's poses
and spawns, once both segmenters are shown to give the same labels.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from morefusion_tpu import runtime as JR
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu.models import segmentation as JS
from morefusion_tpu.models import tiny_singleview3d as j_tiny
from morefusion_tpu.ops import connected_components as j_cc
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch.datasets import ProceduralModels as TModels
from morefusion_tpu_torch.models import segmentation as TS
from morefusion_tpu_torch.ops import connected_components as t_cc
from morefusion_tpu_torch.ops import relabel_components
from morefusion_tpu_torch.simulation import PlaneTypeSceneGeneration
from tests.ops_tests.test_connected_components import _random_class_map
from tests.test_torch_bf16 import carried
from tests.test_torch_pipeline import _compare, _feed_jax_draw

torch.set_num_threads(2)

# the module, which the package's function of the same name shadows
cc_module = importlib.import_module(
    "morefusion_tpu_torch.ops.connected_components")
WIDTHS = (8, 16, 32)


def _unet(**kw):
    return carried(lambda: TS.UNetSegmentation(n_class=5, widths=WIDTHS,
                                               **kw))


@pytest.mark.parametrize("with_boundary", [False, True])
@pytest.mark.parametrize("use_depth", [False, True])
def test_unet_logits_match_jax(rng, with_boundary, use_depth):
    kw = dict(with_boundary=with_boundary, use_depth=use_depth)
    variables, tmodel = _unet(**kw)
    rgb = rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 1.0, (2, 32, 48)).astype(np.float32)
    depth[:, :4] = np.nan
    args = (rgb, depth) if use_depth else (rgb,)
    want = jax.jit(JS.UNetSegmentation(n_class=5, widths=WIDTHS,
                                       **kw).apply)(variables, *args)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in args))
    if not with_boundary:
        want, got = (want,), (got,)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), want[0],
                               atol=1e-5)
    if with_boundary:
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-5)


# --------------------------------------------------------- host helpers


def _touching_label():
    lab = np.full((32, 32), -1, np.int32)
    lab[4:16, 4:28] = 0
    lab[16:28, 4:28] = 1
    return lab


def _split_case():
    cm = np.zeros((64, 64), np.int32)
    cm[8:56, 8:52] = 3
    boundary = np.zeros((64, 64), bool)
    boundary[8:56, 29:32] = True
    return cm, boundary


def _blobs_case():
    cm = np.zeros((64, 64), np.int32)
    cm[5:20, 5:20] = 7
    cm[40:60, 40:60] = 7
    cm[0:3, 60:64] = 7
    return cm


def _masks(H, W, *boxes):
    out = []
    for y1, y2, x1, x2 in boxes:
        m = np.zeros((H, W), bool)
        m[y1:y2, x1:x2] = True
        out.append(m)
    return out


def _merge_cases():
    """The inputs of the JAX tests of ``merge_occlusion_splits``:
    ``(class_map, [(mask, class_id), ...])`` each."""
    cases = {}
    a, occ, b = _masks(60, 80, (20, 40, 10, 30), (15, 45, 30, 36),
                       (20, 40, 36, 56))
    cases["occluded"] = [(a, 3), (b, 3), (occ, 7)]
    a, b, base = _masks(60, 80, (20, 40, 10, 30), (20, 40, 30, 50),
                        (40, 55, 5, 55))
    cases["adjacent"] = [(a, 3), (b, 3), (base, 9)]
    a, b = _masks(60, 80, (20, 40, 5, 25), (20, 40, 35, 55))
    cases["background"] = [(a, 3), (b, 3)]
    a, s = _masks(60, 80, (10, 50, 10, 50), (25, 31, 52, 58))
    cases["splinter"] = [(a, 5), (s, 5)]
    f1, o1, f2, o2, f3 = _masks(60, 100, (20, 40, 5, 25), (10, 50, 25, 31),
                                (20, 40, 31, 51), (10, 50, 51, 57),
                                (20, 40, 57, 77))
    cases["transitive"] = [(f1, 4), (o1, 8), (f2, 4), (o2, 11), (f3, 4)]
    out = {}
    for name, blobs in cases.items():
        cm = np.zeros(blobs[0][0].shape, np.int32)
        label = np.full(cm.shape, -1, np.int32)
        classes = {}
        for k, (m, c) in enumerate(blobs):
            cm[m] = c
            label[m] = k
            classes[k] = c
        out[name] = (label, classes, cm)
    return out


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


_MERGE = _merge_cases()
HELPER_CASES = {
    "boundary_width1": ("boundary_from_instance_label",
                        (_touching_label(),), dict(width=1)),
    "boundary_width2": ("boundary_from_instance_label",
                        (_touching_label(),), {}),
    "split_touching": ("instances_from_predictions", _split_case(),
                       dict(min_area=50)),
    "multi_component": ("instances_from_predictions", (_blobs_case(), None),
                        dict(min_area=20)),
    "largest_component": ("instances_from_class_map", (_blobs_case(),),
                          dict(min_area=50)),
    "miou": ("miou", (np.where(_touching_label() == 0, 5, 0),
                      np.where(_touching_label() >= 0, 5, 0)), {}),
    **{f"merge_{k}": ("merge_occlusion_splits", v, {})
       for k, v in _MERGE.items()},
}


@pytest.mark.parametrize("case", sorted(HELPER_CASES))
def test_host_helper_matches_jax(case):
    name, args, kw = HELPER_CASES[case]
    _same(getattr(TS, name)(*args, **kw), getattr(JS, name)(*args, **kw))


def test_match_instances_matches_jax():
    gt = np.full((32, 32), -1, np.int32)
    gt[2:12, 2:12] = 0
    gt[20:30, 20:30] = 1
    pred = np.full((32, 32), -1, np.int32)
    pred[3:13, 2:12] = 0
    pred[20:30, 20:30] = 1
    for pred_cls in ({0: 5, 1: 5}, {0: 4, 1: 4}, {0: 5, 1: 4}):
        args = (pred, pred_cls, gt, {0: 5, 1: 5})
        assert TS.match_instances(*args) == JS.match_instances(*args)


# -------------------------------------------------- connected components


def _snake(H=24, W=24):
    cm = np.zeros((H, W), np.int32)
    for r in range(0, H, 2):
        cm[r, :] = 1
        if r + 1 < H:
            cm[r + 1, W - 1 if (r // 2) % 2 == 0 else 0] = 1
    return cm


def _cc_case(name):
    if name.startswith("blobs"):
        rng = np.random.RandomState(int(name[-1]))
        cm = _random_class_map(rng)
        return cm, (rng.rand(*cm.shape) < 0.1 if "carved" in name else None)
    if name == "carving":
        cm = np.zeros((40, 60), np.int32)
        cm[10:30, 10:50] = 3
        bnd = np.zeros((40, 60), bool)
        bnd[10:30, 29:31] = True
        return cm, bnd
    if name == "no_bleed":
        cm = np.zeros((20, 30), np.int32)
        cm[5:15, 5:15] = 1
        cm[5:15, 15:25] = 2
        return cm, None
    return _snake(), None


CC_CASES = ["blobs0", "blobs1", "blobs2", "blobs_carved0", "blobs_carved1",
            "carving", "no_bleed", "snake"]


@pytest.mark.parametrize("name", CC_CASES)
def test_connected_components_keys_match_jax(name):
    cm, bnd = _cc_case(name)
    want = np.asarray(j_cc(cm, bnd))
    got, stats = t_cc(torch.from_numpy(cm),
                      None if bnd is None else torch.from_numpy(bnd),
                      return_stats=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(stats["iterations"]) == (1 if bnd is None else 2)
    assert stats["host_reads"] == sum(-(-n // 8) for n in
                                      stats["iterations"])
    if name == "snake":  # one component along a 1-px path
        assert len(np.unique(want[cm > 0])) == 1


@pytest.mark.parametrize("name,max_iters", [
    ("blobs_carved0", 1), ("blobs_carved0", 2), ("blobs_carved0", 3),
    ("snake", 1), ("snake", 2), ("snake", 5), ("snake", 12)])
def test_connected_components_cut_by_max_iters(name, max_iters,
                                               monkeypatch):
    """A cap below the fixed point (blobs_carved0 reaches it in 4 steps,
    the snake in 24) cuts where JAX's cuts, whatever the number of steps
    between host reads."""
    cm, bnd = _cc_case(name)
    want = np.asarray(j_cc(cm, bnd, max_iters=max_iters))
    assert (want != np.asarray(j_cc(cm, bnd))).any()  # cut short
    for check_every in (1, 3, 8):
        monkeypatch.setattr(cc_module, "CHECK_EVERY", check_every)
        got, stats = t_cc(torch.from_numpy(cm),
                          None if bnd is None else torch.from_numpy(bnd),
                          max_iters=max_iters, return_stats=True)
        np.testing.assert_array_equal(got.numpy(), want)
        assert stats["iterations"][0] == max_iters
        assert all(n <= max_iters for n in stats["iterations"])
        assert stats["host_reads"] == sum(-(-n // check_every)
                                          for n in stats["iterations"])


def test_relabel_matches_jax():
    from morefusion_tpu.ops import relabel_components as j_relabel

    cm, bnd = _cc_case("blobs_carved1")
    comp = np.asarray(j_cc(cm, bnd))
    for min_area in (1, 50):
        _same(relabel_components(comp, cm, min_area=min_area),
              j_relabel(comp, cm, min_area=min_area))


# ---------------------------------------------------------------- the node


@pytest.mark.parametrize("device_instancing", [True, False])
@pytest.mark.parametrize("with_boundary", [True, False])
def test_segmentation_node_matches_jax(rng, device_instancing,
                                       with_boundary):
    variables, tmodel = _unet(with_boundary=with_boundary)
    jmodel = JS.UNetSegmentation(n_class=5, widths=WIDTHS,
                                 with_boundary=with_boundary)
    kw = dict(min_area=20, device_instancing=device_instancing)
    rgb = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    want = JS.SegmentationNode(jmodel, variables, **kw)(rgb)
    got = TS.SegmentationNode(tmodel, device="cpu", **kw)(rgb)
    assert want[1], "no instance: the comparison would be empty"
    _same(got, want)


# ------------------------------------------------------------ the pipeline

SHAPE = (64, 96)
V = 16


@pytest.fixture(scope="module")
def seg_frames():
    gen = PlaneTypeSceneGeneration(TModels(), n_object=2,
                                   random_state=np.random.RandomState(3))
    gen.generate()
    traj = gen.random_camera_trajectory(4, 3)
    return [dict(rgb=f["rgb"].astype(np.float32), depth=f["depth"],
                 K=f["intrinsic_matrix"], T_cam2world=f["T_cam2world"])
            for f in (gen.render_frame(T, shape=SHAPE,
                                       n_points_per_object=3000)
                      for T in traj[:3])]


def _segmenters():
    """Both nodes on one seeded random UNet with the boundary head. Its
    instances are noise, not objects, but there are 8-11 a frame on these
    frames, so the pipeline has instances to track and pose."""
    variables, tmodel = carried(lambda: TS.UNetSegmentation(
        n_class=22, widths=WIDTHS, with_boundary=True), seed=4)
    jnode = JS.SegmentationNode(
        JS.UNetSegmentation(n_class=22, widths=WIDTHS, with_boundary=True),
        variables, min_area=20)
    tnode = TS.SegmentationNode(tmodel, min_area=20, device="cpu")
    return jnode, tnode


def test_pipeline_with_segmenter_matches_jax(seg_frames, monkeypatch):
    jseg, tseg = _segmenters()
    # the same instances on every frame first: an argmax near-tie would
    # otherwise hide behind the pose tolerance
    n_instances = 0
    for f in seg_frames:
        want = jseg(f["rgb"], f["depth"])
        _same(tseg(f["rgb"], f["depth"]), want)
        n_instances += len(want[1])
    assert n_instances > 0

    torch.manual_seed(0)
    kw = dict(n_point=32, with_occupancy=True, voxel_dim=V)
    variables, tmodel = carried(lambda: TM.tiny_singleview3d(21, **kw))
    common = dict(voxel_dim=V, n_votes=1, native_mapping=True,
                  size_filter=False)
    jpipe = JR.ScenePipeline(j_tiny(21, **kw), variables, JModels(),
                             segmenter=jseg, **common)
    tpipe = TR.ScenePipeline(tmodel, TModels(), segmenter=tseg,
                             device="cpu", **common)
    _feed_jax_draw(tpipe.pose_node, tmodel.n_point)
    n_poses = 0
    # the ICC refine is held in tests/test_torch_pipeline.py; the segmenter
    # changes only the labels it starts from
    for got, want in zip(tpipe.process_stream(iter(seg_frames), refine=False),
                         jpipe.process_stream(iter(seg_frames), refine=False),
                         strict=True):
        _compare(got, want)
        assert sorted(tpipe.object_mapping.spawned) == sorted(
            jpipe.object_mapping.spawned)
        n_poses += len(want)
    assert n_poses > 0
