"""Thin ROS1 adapter over the ScenePipeline (optional, requires rospy).

Own copy of ``morefusion_tpu/runtime/ros_adapter.py``; its ``main`` builds
the port's models and pipeline on the card (the private param ``~device``,
default ``cuda``, lets a caller ask for the CPU).

The reference implements the serve path as ~10 ROS nodes
(``ros/src/morefusion_ros/nodes/*``); here the pipeline is a library
(``runtime/pipeline.py``) and ROS is only transport: one node subscribes
to synchronized RGB-D + camera info + TF and republishes poses. Import is
gated — the rest of the framework never touches ROS.

Message contract mirrors the reference's ``ObjectPoseArray`` with plain
``geometry_msgs/PoseArray`` + class-id arrays, so it can interoperate with
RViz out of the box.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..geometry.transform import quaternion_from_matrix


def available() -> bool:
    try:
        import rospy  # noqa: F401

        return True
    except ImportError:
        return False


class ScenePipelineNode:
    """rgb + depth + camera_info (+ TF camera pose) -> object poses.

    Equivalent of chaining the reference's mask_rcnn_instance_segmentation,
    OctomapServer, singleview_3d_pose_estimation, object_mapping and
    collision_based_pose_refinement nodes.
    """

    def __init__(self, pipeline, frame_id: str = "map"):
        import cv_bridge
        import message_filters
        import rospy
        import tf
        from geometry_msgs.msg import PoseArray, Pose
        from sensor_msgs.msg import CameraInfo, Image

        self._pipeline = pipeline
        self._frame_id = frame_id
        self._bridge = cv_bridge.CvBridge()
        self._tf = tf.TransformListener(cache_time=rospy.Duration(30))
        self._PoseArray, self._Pose = PoseArray, Pose

        self._pub_poses = rospy.Publisher(
            "~output/poses", PoseArray, queue_size=1
        )

        subs = [
            message_filters.Subscriber("~input/rgb", Image),
            message_filters.Subscriber("~input/depth", Image),
            message_filters.Subscriber("~input/camera_info", CameraInfo),
        ]
        self._sync = message_filters.ApproximateTimeSynchronizer(
            subs, queue_size=5, slop=0.1
        )
        self._sync.registerCallback(self._callback)

    def _lookup_camera_pose(self, header) -> Optional[np.ndarray]:
        import tf.transformations as ttf

        try:
            trans, rot = self._tf.lookupTransform(
                self._frame_id, header.frame_id, header.stamp
            )
        except Exception:
            return None
        T = ttf.quaternion_matrix(rot)
        T[:3, 3] = trans
        return T

    def _callback(self, rgb_msg, depth_msg, info_msg):
        rgb = self._bridge.imgmsg_to_cv2(rgb_msg, desired_encoding="rgb8")
        depth = self._bridge.imgmsg_to_cv2(depth_msg)
        if depth.dtype == np.uint16:
            depth = depth.astype(np.float32) / 1000.0
            depth[depth == 0] = np.nan
        K = np.asarray(info_msg.K, dtype=np.float64).reshape(3, 3)
        T_cam2world = self._lookup_camera_pose(rgb_msg.header)
        if T_cam2world is None:
            T_cam2world = np.eye(4)

        results = self._pipeline.process_frame(
            rgb.astype(np.float32), depth, K, T_cam2world
        )
        self._publish(results, rgb_msg.header)

    def _publish(self, results, header):
        msg = self._PoseArray()
        msg.header.stamp = header.stamp
        msg.header.frame_id = self._frame_id
        for res in results.values():
            T = res.get("T_cad2world_refined", res.get("T_cad2world"))
            q = quaternion_from_matrix(T)
            p = self._Pose()
            p.position.x, p.position.y, p.position.z = T[:3, 3]
            (p.orientation.w, p.orientation.x, p.orientation.y,
             p.orientation.z) = q
            msg.poses.append(p)
        self._pub_poses.publish(msg)


def _segmenter(seg_dir, device):
    """The ``cli/train_segmentation.py`` run's UNet, at the widths and
    heads its ``args.json`` names, with its latest weights (seeded ones
    where the run holds none, as JAX keeps its init)."""
    import torch

    from .. import training
    from ..models.segmentation import SegmentationNode, UNetSegmentation

    seg_args = training.load_args(seg_dir)
    torch.manual_seed(0)
    model = UNetSegmentation(
        n_class=22, widths=tuple(seg_args.get("widths", (32, 64, 128, 256))),
        with_boundary=not seg_args.get("no_boundary", False),
        use_depth=seg_args.get("use_depth", False)).to(device)
    training.CheckpointManager(seg_dir).restore_latest(
        training.create_train_state(model))
    return SegmentationNode(model, device=device)


def main():
    """rosrun entry point: build the pipeline and spin."""
    import rospy
    import torch

    from ..datasets import ProceduralModels
    from ..models import SingleView3D
    from ..runtime import ScenePipeline
    from ..training import CheckpointManager

    rospy.init_node("morefusion_tpu_pipeline")
    log_dir = rospy.get_param("~log_dir")
    seg_dir = rospy.get_param("~segmentation_log_dir", None)
    device = torch.device(rospy.get_param("~device", "cuda"))

    models = ProceduralModels()
    torch.manual_seed(0)
    model = SingleView3D(n_fg_class=21, with_occupancy=True).to(device)
    # no best snapshot: the seeded weights stay, as JAX keeps its init
    CheckpointManager(log_dir).restore_best(model, "validation/main/auc")

    segmenter = _segmenter(seg_dir, device) if seg_dir else None
    pipeline = ScenePipeline(model, models, segmenter=segmenter,
                             device=device)
    ScenePipelineNode(pipeline)
    rospy.spin()


if __name__ == "__main__":
    main()
