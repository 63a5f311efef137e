"""The port's scene pipeline against ``morefusion_tpu.runtime.ScenePipeline``.

Same seeds through both packages on the CPU, at a small size: 2 objects,
120x160 frames of 6000 points an object. The NumPy stages are copies, so
frames, tracking, fusion (native C++ and NumPy mapping) and the spawn
decisions agree exactly. The whole pipeline runs a tiny SingleView3D
(weights carried across by ``params_from_jax``) at a 16^3 grid, with the
port's point sampling fed JAX's draw: poses agree within 1e-5 (fp32 on
both sides, as ``test_torch_node.py``), the ICC problems the pipelines
build agree, and so does their refinement: within the 1e-4 of
``test_torch_icc.py`` over 5 iterations, and within JAX's own spread under
a 1e-7 start jitter over the pipeline's 30.
"""

import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu import runtime as JR
from morefusion_tpu.contrib import collision_refine as JC
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu.datasets.ycb_video.class_names import (
    class_ids_symmetric,
)
from morefusion_tpu.models import tiny_singleview3d as j_tiny
from morefusion_tpu.models.sampling import sample_mask_indices
from morefusion_tpu.runtime import pipeline as JPm
from morefusion_tpu.runtime import pose_estimation as JP
from morefusion_tpu.simulation import BinTypeSceneGeneration as JBin
from morefusion_tpu.simulation import PlaneTypeSceneGeneration as JGen
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch.contrib import collision_refine as TC
from morefusion_tpu_torch.contrib import mapping_native
from morefusion_tpu_torch.datasets import ProceduralModels as TModels
from morefusion_tpu_torch.geometry import pointcloud_from_depth
from morefusion_tpu_torch.runtime import pipeline as TPm
from morefusion_tpu_torch.simulation import BinTypeSceneGeneration as TBin
from morefusion_tpu_torch.simulation import PlaneTypeSceneGeneration as TGen
from tests.test_torch_model import torch_to_flax

torch.set_num_threads(2)

SHAPE = (120, 160)
V = 16  # the whole-pipeline test's grid


def _frames(gen_cls, models, seed, n=3):
    gen = gen_cls(models, n_object=2, random_state=np.random.RandomState(seed))
    gen.generate()
    traj = gen.random_camera_trajectory(4, 3)
    frames = [gen.render_frame(T, shape=SHAPE, n_points_per_object=6000)
              for T in traj[:n]]
    return gen, frames


@pytest.fixture(scope="module")
def frames():
    return _frames(TGen, TModels(), 3)[1]


def _stream_frame(frame):
    return dict(
        rgb=frame["rgb"].astype(np.float32),
        depth=frame["depth"],
        K=frame["intrinsic_matrix"],
        T_cam2world=frame["T_cam2world"],
        instance_label=frame["instance_label"],
        instance_to_class={int(i): int(frame["class_ids"][k])
                           for k, i in enumerate(frame["instance_ids"])},
    )


def _world_cloud(frame):
    K = frame["intrinsic_matrix"]
    pcd = pointcloud_from_depth(frame["depth"], K[0, 0], K[1, 1], K[0, 2],
                                K[1, 2])
    T = frame["T_cam2world"]
    return pcd @ T[:3, :3].T + T[:3, 3]


@pytest.mark.parametrize("bin_type,seed", [(False, 3), (False, 11),
                                            (True, 3), (True, 11)],
                         ids=["3", "11", "bin-3", "bin-11"])
def test_scene_frames_bit_identical(bin_type, seed):
    jcls, tcls = (JBin, TBin) if bin_type else (JGen, TGen)
    jgen, jframes = _frames(jcls, JModels(), seed)
    tgen, tframes = _frames(tcls, TModels(), seed)
    assert sorted(jgen.objects) == sorted(tgen.objects)
    for i in jgen.objects:
        np.testing.assert_array_equal(tgen.objects[i]["T_cad2world"],
                                      jgen.objects[i]["T_cad2world"])
    for jf, tf in zip(jframes, tframes):
        assert sorted(jf) == sorted(tf)
        for k in jf:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        assert tf["rgb"].dtype == jf["rgb"].dtype == np.uint8


def _tracking_case(frames):
    """Map labels rendered from frame 0 (ids shifted) against frame 1's
    detections, plus a small blob and a blob on the image border."""
    reference = np.where(frames[0]["instance_label"] >= 0,
                         frames[0]["instance_label"] + 5, -2)
    target = frames[1]["instance_label"].copy()
    target[50:54, 70:74] = 7  # too small for the size filter
    target[:20, :30] = 8  # mostly in the border band
    classes = {0: 2, 1: 6, 7: 3, 8: 9}
    return reference.astype(np.int32), target.astype(np.int32), classes


@pytest.mark.parametrize("size_filter", [True, False])
def test_track_instance_id(frames, size_filter):
    reference, target, classes = _tracking_case(frames)
    want = JR.track_instance_id(reference, target, classes, 9,
                                size_filter=size_filter)
    got = TR.track_instance_id(reference, target, classes, 9,
                               size_filter=size_filter)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    assert TR.is_detected_mask_too_small(target == 7)
    assert TR.mask_to_bbox(target == 8) == JR.mask_to_bbox(target == 8)


def test_size_filter_without_cv2_raises(frames):
    """Where cv2 is missing, the size filter raises; it is never skipped.
    Without the filter, tracking needs no cv2."""
    reference, target, classes = _tracking_case(frames)
    want = JR.track_instance_id(reference, target, classes, 9,
                                size_filter=False)
    with mock.patch.dict(sys.modules, {"cv2": None}):
        with pytest.raises(ImportError, match="size_filter"):
            TR.track_instance_id(reference, target, classes, 9,
                                 size_filter=True)
        got = TR.track_instance_id(reference, target, classes, 9,
                                   size_filter=False)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("native", [True, False])
def test_occupancy_fusion(frames, native):
    jmodels, tmodels = JModels(), TModels()
    jf = JR.OccupancyFusion(jmodels, native=native, size_filter=False)
    tf = TR.OccupancyFusion(tmodels, native=native, size_filter=False)
    kind = ("NativeMultiInstanceMapping" if native
            else "MultiInstanceOccupancyMapping")
    assert type(jf._mapping).__name__ == type(tf._mapping).__name__ == kind
    for frame in frames:
        f = _stream_frame(frame)
        pcd = _world_cloud(frame)
        args = (pcd, f["instance_label"], f["instance_to_class"])
        kw = dict(K=f["K"], T_cam2world=f["T_cam2world"],
                  camera_origin=f["T_cam2world"][:3, 3])
        want = jf.process_frame(*args, **kw)
        got = tf.process_frame(*args, **kw)
        np.testing.assert_array_equal(got, want)
        assert tf.instance_to_class == jf.instance_to_class
        ids = sorted(tf.instance_to_class)
        pitches = [tmodels.get_voxel_pitch(32, tf.instance_to_class[i])
                   for i in ids]
        assert pitches == [jmodels.get_voxel_pitch(32, jf.instance_to_class[i])
                           for i in ids]
        origins = np.stack([
            np.nanmedian(pcd[got == i], axis=0) - p * 15.5
            if (got == i).any() else np.zeros(3)
            for i, p in zip(ids, pitches)])
        for a, b in zip(tf.get_grids_batch(ids, pitches, origins),
                        jf.get_grids_batch(ids, pitches, origins)):
            np.testing.assert_array_equal(a, b)


def test_native_fusion_raises_when_the_build_fails(tmp_path, monkeypatch):
    """``native=True`` raises with the compiler's output; it does not fall
    back to the NumPy mapping."""
    bad = tmp_path / "mapping.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(mapping_native, "SOURCE", bad)
    monkeypatch.setattr(mapping_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(mapping_native, "LIB_PATH", tmp_path / "libmfm.so")
    monkeypatch.setattr(mapping_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TR.OccupancyFusion(TModels(), native=True)
    assert not (tmp_path / "libmfm.so").exists()


def test_native_library_lands_in_the_build_dir():
    mapping_native.load_library()
    assert mapping_native.LIB_PATH.parent.name == "_build"
    assert mapping_native.LIB_PATH.exists() and not mapping_native.stale()


@pytest.mark.parametrize("n_votes", [1, 3])
def test_object_mapping_spawns(rng, n_votes):
    """Pose sequences of a symmetric and an asymmetric class, some
    consistent (a few mm of noise) and some not: the same tracks spawn at
    the same updates, with the same poses."""
    jm = JR.ObjectMapping(JModels(), class_ids_symmetric, n_votes=n_votes)
    tm = TR.ObjectMapping(TModels(), class_ids_symmetric, n_votes=n_votes)
    classes = {0: 2, 1: 16, 2: 5, 3: 21}
    noise = {0: 0.002, 1: 0.004, 2: 0.05, 3: 0.015}
    for _ in range(6):
        for ins_id, class_id in classes.items():
            T = np.eye(4)
            T[:3, 3] = [0.1 * ins_id, 0.0, 0.6]
            T[:3, 3] += rng.normal(0, noise[ins_id], 3)
            jt = jm.update(ins_id, class_id, T)
            tt = tm.update(ins_id, class_id, T)
            assert tt.is_spawned == jt.is_spawned
        assert sorted(tm.spawned) == sorted(jm.spawned)
        for i, track in tm.spawned.items():
            np.testing.assert_array_equal(track.pose, jm.spawned[i].pose)
    if n_votes == 1:  # a single pose spawns its track
        assert len(tm.spawned) == len(classes)
    else:
        assert 0 < len(tm.spawned) < len(classes)


def _pipelines(async_refine):
    torch.manual_seed(0)
    kw = dict(n_point=32, with_occupancy=True, voxel_dim=V)
    variables = torch_to_flax(TM.tiny_singleview3d(21, **kw))
    tmodel = TM.tiny_singleview3d(21, **kw)
    flat, _ = jax.tree_util.tree_flatten_with_path(variables)
    tmodel.load_state_dict(TM.params_from_jax(
        {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}))
    common = dict(voxel_dim=V, n_votes=1, native_mapping=True,
                  size_filter=False, async_refine=async_refine)
    jpipe = JR.ScenePipeline(j_tiny(21, **kw), variables, JModels(), **common)
    tpipe = TR.ScenePipeline(tmodel, TModels(), device="cpu", **common)
    _feed_jax_draw(tpipe.pose_node, tmodel.n_point)
    return jpipe, tpipe


def _feed_jax_draw(node, n_point, S=256):
    """Wrap the port node's ``dispatch`` so that it samples the pixels the
    JAX node draws: jax.random under PRNGKey(1234) on the crops' masks,
    the batch padded to a power of two with its first instance."""
    dispatch = node.dispatch
    crop = jax.jit(JP._crop_instance_device, static_argnums=5)

    def fed(rgb, pcd, label, inst_to_class, noentry_grids=None):
        finite = ~np.isnan(pcd).any(axis=2)
        ids, bboxes = [], []
        for ins_id in inst_to_class:
            mask = label == ins_id
            if not (mask & finite).any():
                continue
            ys, xs = np.nonzero(mask)
            bbox = (ys.min(), xs.min(), ys.max() + 1, xs.max() + 1)
            ids.append(ins_id)
            bboxes.append(bbox)
        if not ids:
            return dispatch(rgb, pcd, label, inst_to_class, noentry_grids)
        B = len(ids)
        take = list(range(B)) + [0] * ((1 << (B - 1).bit_length()) - B)
        crops = [crop(rgb, pcd.astype(np.float32), label.astype(np.int32),
                      ids[k], np.asarray(bboxes[k], np.int32), S)
                 for k in take]
        mask = jnp.stack([~jnp.any(jnp.isnan(c[1]), -1) for c in crops])
        idx = np.asarray(sample_mask_indices(mask, jax.random.PRNGKey(1234),
                                             n_point))
        return dispatch(rgb, pcd, label, inst_to_class, noentry_grids,
                        sample_indices=dict(zip(ids, idx[:B])))

    node.dispatch = fed


def _compare(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i]["class_id"] == want[i]["class_id"]
        for key in ("T_cad2cam", "T_cad2world"):
            np.testing.assert_allclose(got[i][key], want[i][key], atol=1e-5,
                                       err_msg=f"{key} of {i}")
        assert ("T_cad2world_refined" in got[i]) == (
            "T_cad2world_refined" in want[i])


def _recording(module, monkeypatch):
    """Record every ICC problem ``module``'s pipeline builds, and what its
    refine returned."""
    problems = []

    class Recorded(module.IterativeCollisionCheck):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            problems.append(dict(args=args, kw=kw))

        def resolve(self):
            out = super().resolve()
            problems[-1]["refined"], _, problems[-1]["n_iter"] = out
            return out

    monkeypatch.setattr(module, "IterativeCollisionCheck", Recorded)
    return problems


@pytest.mark.parametrize("mode,async_refine", [("frame", False),
                                               ("frame", True),
                                               ("stream", False),
                                               ("stream", True)])
def test_scene_pipeline(frames, monkeypatch, mode, async_refine):
    """Poses, spawns and the ICC problems each frame builds agree with JAX.

    The recorded ICC problems are replayed for 5 iterations in both
    packages and held to the 1e-4 of ``test_torch_icc.py``, and every
    refined pose the port's pipeline returns is the one its own refine of
    the recorded problem gave. The pipeline's 30 iterations are held in
    ``test_icc_30_iterations_within_jax_spread``."""
    j_problems = _recording(JPm, monkeypatch)
    t_problems = _recording(TPm, monkeypatch)
    jpipe, tpipe = _pipelines(async_refine)
    stream = [_stream_frame(f) for f in frames]
    if mode == "frame":
        def run(pipe):
            for f in stream:
                yield pipe.process_frame(
                    f["rgb"], f["depth"], f["K"], f["T_cam2world"],
                    instance_label=f["instance_label"],
                    instance_to_class=f["instance_to_class"], refine=True)
    else:
        def run(pipe):
            return pipe.process_stream(iter(stream), refine=True)
    refined = []
    for got, want in zip(run(tpipe), run(jpipe), strict=True):
        _compare(got, want)
        assert sorted(tpipe.object_mapping.spawned) == sorted(
            jpipe.object_mapping.spawned)
        refined += [r["T_cad2world_refined"] for r in got.values()
                    if "T_cad2world_refined" in r]
    want, got = jpipe.flush_refine(), tpipe.flush_refine()
    assert sorted(got) == sorted(want)
    refined += list(got.values())
    assert refined

    # the same ICC problems: start poses within the pose tolerance, the
    # solids, pitches, origins and uint8 grids equal
    assert len(t_problems) == len(j_problems) > 0
    for tp, jp in zip(t_problems, j_problems):
        assert tp["kw"] == dict(jp["kw"], device=torch.device("cpu"))
        np.testing.assert_allclose(np.stack(tp["args"][0]),
                                   np.stack(jp["args"][0]), atol=1e-5)
        for a, b in zip(tp["args"][1:], jp["args"][1:]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        j_T, j_l, j_n = JC.IterativeCollisionCheck(
            *jp["args"], **jp["kw"]).refine(iterations=5)
        t_T, t_l, t_n = TC.IterativeCollisionCheck(
            *jp["args"], **tp["kw"]).refine(iterations=5)
        assert t_n == j_n
        np.testing.assert_allclose(t_l, j_l, atol=1e-5)
        np.testing.assert_allclose(t_T, j_T, atol=1e-4)
    # every refined pose out of the port's pipeline is its refine's result
    results = np.concatenate([p["refined"] for p in t_problems])
    for T in refined:
        assert (results == T).all(axis=(1, 2)).any()


@pytest.fixture(scope="module")
def jax_icc_problems(frames):
    """The ICC problems JAX's synchronous pipeline builds on ``frames``,
    with what its 30-iteration refine returned."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        problems = _recording(JPm, monkeypatch)
        jpipe, _ = _pipelines(False)
        for f in map(_stream_frame, frames):
            jpipe.process_frame(
                f["rgb"], f["depth"], f["K"], f["T_cam2world"],
                instance_label=f["instance_label"],
                instance_to_class=f["instance_to_class"], refine=True)
    assert problems
    return problems


ICC_START_JITTER = 1e-7  # m: about one float32 ulp of the translations


def test_icc_30_iterations_within_jax_spread(jax_icc_problems):
    """The refined poses after the pipeline's 30 ICC iterations.

    On this scene the refine does not plateau, and JAX's own result moves
    by far more than 1e-4 when its start translations move by 1e-7: Adam's
    first step is ``lr * sign(g)`` in every parameter, and the loss jumps
    where a voxel's nearest point (whose distance sets the voxel's value)
    changes. So two implementations that round differently cannot meet
    1e-4 here at 30 iterations. This holds it: JAX against itself from
    jittered starts spreads past 1e-4, and the port from JAX's starts ends
    no farther from JAX than that spread, with JAX's n_iter."""
    spread = port_err = 0.0
    for k, jp in enumerate(jax_icc_problems):
        args, kw = jp["args"], jp["kw"]
        rng = np.random.RandomState(k)
        for _ in range(3):
            starts = [np.array(T) for T in args[0]]
            for T in starts:
                T[:3, 3] += rng.normal(0, ICC_START_JITTER, 3)
            T_j, _, _ = JC.IterativeCollisionCheck(
                starts, *args[1:], **kw).refine(iterations=30)
            spread = max(spread, float(np.abs(T_j - jp["refined"]).max()))
        T_t, _, n_t = TC.IterativeCollisionCheck(
            *args, **kw, device="cpu").refine(iterations=30)
        assert n_t == jp["n_iter"]
        port_err = max(port_err, float(np.abs(T_t - jp["refined"]).max()))
    print(f"30 ICC iterations: JAX against itself under the jitter "
          f"{spread}, the port against JAX {port_err}")
    assert spread > 1e-4
    assert port_err <= spread, (port_err, spread)


def test_scene_pipeline_defaults_to_the_card():
    """Without ``device=`` the pipeline goes to CUDA; with no card that
    fails rather than running on the CPU."""
    model = TM.tiny_singleview3d(21, n_point=8, with_occupancy=True)
    if torch.cuda.is_available():
        pipe = TR.ScenePipeline(model, TModels(), native_mapping=False)
        assert pipe.pose_node._device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            TR.ScenePipeline(model, TModels(), native_mapping=False)
