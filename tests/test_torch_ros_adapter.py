"""The port's ROS node against ``morefusion_tpu.runtime.ros_adapter``,
without a ROS install: stub ``rospy``, ``cv_bridge``, ``message_filters``,
``tf`` and message modules (as ``runtime_tests/test_ros_adapter.py``), the
synchronized callback driven directly.

- The two cases of ``test_ros_adapter.py`` (uint16 mm depth with 0 -> NaN,
  K from ``CameraInfo.K``, identity without TF, refined over raw poses as
  wxyz quaternions; the TF pose when there is one) on both packages: the
  same pipeline calls and the same messages.
- The JAX node over the JAX ``ScenePipeline`` against the port's node over
  the port's pipeline (tiny model, weights carried across by
  ``params_from_jax``, the port fed JAX's pixel draw) on one generator
  frame in mm: published poses within the pipeline tolerance 1e-5 of
  ``test_torch_pipeline.py``.
- The port's ``main()`` on the CPU (``~device`` = ``cpu``) from run
  directories the port's ``CheckpointManager`` writes (the pose model
  patched to the tiny one: full width is for the card), over three frames:
  the published poses equal, bit for bit, a direct ``process_frame`` of a
  second pipeline built by ``main`` the same way.
"""

import json
import sys
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from morefusion_tpu import runtime as JR
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu.models import tiny_singleview3d as j_tiny
from morefusion_tpu.runtime import ros_adapter as JA
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch import training
from morefusion_tpu_torch.datasets import ProceduralModels as TModels
from morefusion_tpu_torch.geometry.transform import (
    quaternion_from_matrix,
    quaternion_matrix_np,
)
from morefusion_tpu_torch.models.segmentation import UNetSegmentation
from morefusion_tpu_torch.runtime import ros_adapter as TA
from morefusion_tpu_torch.simulation import PlaneTypeSceneGeneration
from tests.test_torch_model import torch_to_flax
from tests.test_torch_pipeline import _feed_jax_draw

torch.set_num_threads(2)

POSE_ATOL = 1e-5  # test_torch_pipeline.py's pipeline tolerance
SHAPE = (120, 160)


class _Attr:
    def __init__(self):
        self.x = self.y = self.z = self.w = 0.0


class _Pose:
    def __init__(self):
        self.position = _Attr()
        self.orientation = _Attr()


class _Header:
    def __init__(self, frame_id="camera", stamp=0.0):
        self.frame_id = frame_id
        self.stamp = stamp


class _PoseArray:
    def __init__(self):
        self.header = _Header()
        self.poses = []


class _Msg:
    def __init__(self, data, stamp=0.0):
        self.data = data
        self.header = _Header(stamp=stamp)


def tf_quaternion_matrix(rot):
    """``tf.transformations.quaternion_matrix``: x, y, z, w."""
    x, y, z, w = rot
    return quaternion_matrix_np([w, x, y, z])


def tf_of(T):
    """(translation, x-y-z-w rotation) of a pose, as TF gives them."""
    w, x, y, z = quaternion_from_matrix(T)
    return tuple(T[:3, 3]), (x, y, z, w)


def install_ros(monkeypatch, camera_poses=None, params=None, spin=None):
    """Stub ROS modules; ``camera_poses`` maps a stamp to its camera pose
    (no entry: the lookup raises). Returns the published messages and the
    registered synchronizers."""
    published, synchronizers = [], []
    rospy = types.ModuleType("rospy")
    rospy.Duration = lambda s: s
    rospy.init_node = lambda name: None
    rospy.get_param = lambda name, *default: (params or {}).get(
        name, *default)
    rospy.spin = lambda: spin(synchronizers[-1].cb)

    class Publisher:
        def __init__(self, topic, msg_type, queue_size=1):
            self.topic = topic

        def publish(self, msg):
            published.append(msg)

    rospy.Publisher = Publisher

    cv_bridge = types.ModuleType("cv_bridge")

    class CvBridge:
        def imgmsg_to_cv2(self, msg, desired_encoding=None):
            return msg.data

    cv_bridge.CvBridge = CvBridge

    message_filters = types.ModuleType("message_filters")

    class Subscriber:
        def __init__(self, topic, msg_type):
            self.topic = topic

    class ApproximateTimeSynchronizer:
        def __init__(self, subs, queue_size=5, slop=0.1):
            self.cb = None

        def registerCallback(self, cb):
            self.cb = cb
            synchronizers.append(self)

    message_filters.Subscriber = Subscriber
    message_filters.ApproximateTimeSynchronizer = ApproximateTimeSynchronizer

    tf_mod = types.ModuleType("tf")

    class TransformListener:
        def __init__(self, cache_time=None):
            pass

        def lookupTransform(self, target, source, stamp):
            if stamp not in (camera_poses or {}):
                raise RuntimeError("no tf")
            return tf_of(camera_poses[stamp])

    tf_mod.TransformListener = TransformListener
    ttf = types.ModuleType("tf.transformations")
    ttf.quaternion_matrix = tf_quaternion_matrix
    tf_mod.transformations = ttf

    gm = types.ModuleType("geometry_msgs")
    gm_msg = types.ModuleType("geometry_msgs.msg")
    gm_msg.PoseArray, gm_msg.Pose = _PoseArray, _Pose
    gm.msg = gm_msg
    sm = types.ModuleType("sensor_msgs")
    sm_msg = types.ModuleType("sensor_msgs.msg")
    sm_msg.CameraInfo = sm_msg.Image = object
    sm.msg = sm_msg
    for name, mod in [("rospy", rospy), ("cv_bridge", cv_bridge),
                      ("message_filters", message_filters), ("tf", tf_mod),
                      ("tf.transformations", ttf), ("geometry_msgs", gm),
                      ("geometry_msgs.msg", gm_msg), ("sensor_msgs", sm),
                      ("sensor_msgs.msg", sm_msg)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return published, synchronizers


def poses_of(msg):
    """(n, 7) positions and w-x-y-z quaternions of a PoseArray."""
    return np.array([[p.position.x, p.position.y, p.position.z,
                      p.orientation.w, p.orientation.x, p.orientation.y,
                      p.orientation.z] for p in msg.poses])


def published_poses(results):
    """What the node publishes for a pipeline's results."""
    rows = []
    for res in results.values():
        T = res.get("T_cad2world_refined", res.get("T_cad2world"))
        rows.append(np.concatenate([T[:3, 3], quaternion_from_matrix(T)]))
    return np.array(rows)


class _RecordingPipeline:
    def __init__(self):
        self.calls = []

    def process_frame(self, rgb, depth, K, T_cam2world):
        self.calls.append(dict(rgb=rgb, depth=depth, K=K,
                               T_cam2world=T_cam2world))
        T = np.eye(4)
        T[:3, 3] = [1.0, 2.0, 3.0]
        T_ref = np.eye(4)
        T_ref[:3, :3] = tf_quaternion_matrix((0.0, 0.6, 0.0, 0.8))[:3, :3]
        T_ref[:3, 3] = [1.5, 2.5, 3.5]
        return {7: {"T_cad2world": T, "T_cad2world_refined": T_ref},
                9: {"T_cad2world": T}}


@pytest.mark.parametrize("with_tf", [False, True], ids=["no_tf", "tf"])
def test_adapter_callback_and_publish(monkeypatch, with_tf):
    """``test_ros_adapter.py``'s two cases, both packages."""
    T_cam = tf_quaternion_matrix((0.0, 0.0, 0.0, 1.0))
    T_cam[:3, 3] = [0.1, 0.2, 0.3]
    runs = []
    for A in (JA, TA):
        published, _ = install_ros(monkeypatch,
                                   {0.0: T_cam} if with_tf else None)
        pipe = _RecordingPipeline()
        node = A.ScenePipelineNode(pipe, frame_id="map")
        depth_mm = np.full((8, 10), 1500, np.uint16)
        depth_mm[0, 0] = 0
        info = types.SimpleNamespace(
            K=[525.0, 0, 320, 0, 525.0, 240, 0, 0, 1], header=_Header())
        node._sync.cb(_Msg(np.zeros((8, 10, 3), np.uint8)), _Msg(depth_mm),
                      info)
        runs.append((pipe.calls, published))
    (j_calls, j_pub), (t_calls, t_pub) = runs
    assert len(t_calls) == len(j_calls) == 1
    for key in ("rgb", "depth", "K", "T_cam2world"):
        a, b = t_calls[0][key], j_calls[0][key]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=key)
    call = t_calls[0]
    assert np.isnan(call["depth"][0, 0])
    assert call["depth"][1, 1] == pytest.approx(1.5)
    np.testing.assert_array_equal(call["T_cam2world"],
                                  T_cam if with_tf else np.eye(4))
    assert len(t_pub) == len(j_pub) == 1
    assert t_pub[0].header.frame_id == j_pub[0].header.frame_id == "map"
    np.testing.assert_array_equal(poses_of(t_pub[0]), poses_of(j_pub[0]))
    np.testing.assert_allclose(poses_of(t_pub[0])[0],
                               [1.5, 2.5, 3.5, 0.8, 0.0, 0.6, 0.0],
                               atol=1e-15)


def _frames(n, seed=3):
    gen = PlaneTypeSceneGeneration(TModels(), n_object=2,
                                   random_state=np.random.RandomState(seed))
    gen.generate()
    return [gen.render_frame(T, shape=SHAPE, n_points_per_object=6000)
            for T in gen.random_camera_trajectory(4, 3)[:n]]


def to_messages(frame, stamp):
    """The frame as the camera sends it: rgb8, depth in uint16 mm
    (0 where there is none), K."""
    depth = np.nan_to_num(frame["depth"], nan=0.0)
    depth_mm = np.round(depth * 1000.0).astype(np.uint16)
    info = types.SimpleNamespace(K=list(frame["intrinsic_matrix"].ravel()),
                                 header=_Header(stamp=stamp))
    return _Msg(frame["rgb"], stamp), _Msg(depth_mm, stamp), info


def test_node_over_pipelines_against_jax(monkeypatch):
    """One generator frame through each package's node over its own
    pipeline (ground-truth labels put in by the recording pipeline's
    segmenter: the frame's own)."""
    frame = _frames(1)[0]
    torch.manual_seed(0)
    kw = dict(n_point=32, with_occupancy=True, voxel_dim=16)
    variables = torch_to_flax(TM.tiny_singleview3d(21, **kw))
    tmodel = TM.tiny_singleview3d(21, **kw)
    flat, _ = jax.tree_util.tree_flatten_with_path(variables)
    tmodel.load_state_dict(TM.params_from_jax(
        {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}))
    classes = {int(i): int(frame["class_ids"][k])
               for k, i in enumerate(frame["instance_ids"])}

    def segmenter(rgb, depth):
        return frame["instance_label"], classes

    common = dict(voxel_dim=16, native_mapping=True, size_filter=False,
                  segmenter=segmenter)
    jpipe = JR.ScenePipeline(j_tiny(21, **kw), variables, JModels(),
                             **common)
    tpipe = TR.ScenePipeline(tmodel, TModels(), device="cpu", **common)
    _feed_jax_draw(tpipe.pose_node, tmodel.n_point)
    out = []
    for A, pipe in ((JA, jpipe), (TA, tpipe)):
        published, _ = install_ros(monkeypatch,
                                   {0.0: frame["T_cam2world"]})
        A.ScenePipelineNode(pipe)._sync.cb(*to_messages(frame, 0.0))
        out.append(poses_of(published[0]))
    assert out[1].shape == out[0].shape == (len(classes), 7)
    np.testing.assert_allclose(out[1], out[0], atol=POSE_ATOL)


def _run_dirs(tmp_path):
    """A best snapshot of a tiny pose model and the latest snapshot of a
    narrow segmenter, both by the port's ``CheckpointManager``."""
    torch.manual_seed(5)
    model = TM.tiny_singleview3d(21, with_occupancy=True)
    pose_dir = tmp_path / "occ"
    training.CheckpointManager(str(pose_dir)).save_best(
        model, "validation/main/auc", 0.5)
    seg_dir = tmp_path / "seg"
    torch.manual_seed(6)
    unet = UNetSegmentation(n_class=22, widths=(8, 16), with_boundary=True)
    training.CheckpointManager(str(seg_dir)).save_latest(
        training.create_train_state(unet), 3)
    with open(seg_dir / "args.json", "w") as f:
        json.dump(dict(widths=[8, 16]), f)
    return str(pose_dir), str(seg_dir), model, unet


def tiny_pose_models(monkeypatch):
    """Make ``main``'s full-width ``SingleView3D`` the tiny one (full width
    is for the card); returns the models it builds."""
    built, full = [], TM.SingleView3D

    def tiny(n_fg_class, **kw):
        with mock.patch.object(TM, "SingleView3D", full):
            built.append(TM.tiny_singleview3d(n_fg_class, **kw))
        return built[-1]

    monkeypatch.setattr(TM, "SingleView3D", tiny)
    return built


def test_main_on_the_cpu(monkeypatch, tmp_path):
    pose_dir, seg_dir, model, unet = _run_dirs(tmp_path)
    frames = _frames(3)
    camera_poses = {float(k): f["T_cam2world"] for k, f in enumerate(frames)}
    params = {"~log_dir": pose_dir, "~segmentation_log_dir": seg_dir,
              "~device": "cpu"}
    built = tiny_pose_models(monkeypatch)

    def feed(cb):
        for k, f in enumerate(frames):
            cb(*to_messages(f, float(k)))

    published, syncs = install_ros(monkeypatch, camera_poses, params, feed)
    TA.main()
    assert len(published) == len(frames)
    # the restored weights, on the CPU
    node = syncs[-1].cb.__self__
    pipe = node._pipeline
    for a, b in zip(built[0].state_dict().values(),
                    model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    seg_model = pipe._segmenter._model
    assert seg_model.with_boundary and seg_model.widths == (8, 16)
    for a, b in zip(seg_model.state_dict().values(),
                    unet.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert pipe.pose_node._device == torch.device("cpu")

    # a second pipeline built by main, fed directly
    direct = []

    def process(cb):
        pipe2 = cb.__self__._pipeline
        for k, f in enumerate(frames):
            _, depth_msg, info = to_messages(f, float(k))
            depth = depth_msg.data.astype(np.float32) / 1000.0
            depth[depth == 0] = np.nan
            T = tf_quaternion_matrix(tf_of(f["T_cam2world"])[1])
            T[:3, 3] = f["T_cam2world"][:3, 3]
            direct.append(published_poses(pipe2.process_frame(
                f["rgb"].astype(np.float32), depth,
                np.asarray(info.K, np.float64).reshape(3, 3), T)))

    install_ros(monkeypatch, camera_poses, params, process)
    TA.main()
    assert len(direct) == len(published)
    for got, want in zip(published, direct):
        np.testing.assert_array_equal(poses_of(got).reshape(want.shape),
                                      want)


def test_main_defaults_to_the_card(monkeypatch, tmp_path):
    """Without ``~device`` the node's models go to CUDA; with no card that
    fails rather than running on the CPU."""
    pose_dir, _, _, _ = _run_dirs(tmp_path)
    tiny_pose_models(monkeypatch)
    install_ros(monkeypatch, params={"~log_dir": pose_dir},
                spin=lambda cb: None)
    if torch.cuda.is_available():
        TA.main()
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            TA.main()
