"""Serving nodes of the port (``morefusion_tpu.runtime``): the pose node, the
segmentation node and the scene pipeline with its fusion, tracking and object
mapping, the sequence recorder and player, and the robot side: picking
order, pick-and-place planning and its state machine, the planning scene,
trajectory execution and the MoveIt binding. The ROS node
(``ros_adapter``) is imported on its own, as in JAX's package."""

# flake8: noqa: F401

from ..models.segmentation import SegmentationNode
from .fusion import OccupancyFusion
from .object_mapping import ObjectMapping
from .object_mapping import ObjectTrack
from .moveit_robot import JOINT_POSITIONS
from .moveit_robot import MoveItRobotInterface
from .moveit_robot import RosServiceTransport
from .moveit_robot import SerialSuction
from .moveit_robot import build_move_request
from .picking import build_occlusion_graph
from .picking import select_picking_order
from .picking import suction_grasp_pose
from .pipeline import ScenePipeline
from .planning_scene import CollisionAwareRobot
from .planning_scene import PlanningScene
from .planning_scene import SceneObject
from .pose_estimation import PoseEstimationNode
from .replay import SequenceRecorder
from .replay import load_sequence
from .replay import play_sequence
from .robot import PickAction
from .robot import PickAndPlacePlanner
from .robot import PickAndPlaceStateMachine
from .robot import PickOutcome
from .robot import RobotInterface
from .robot import SimulatedRobotInterface
from .tracking import is_detected_mask_too_small
from .tracking import mask_to_bbox
from .tracking import track_instance_id
from .trajectory_exec import TrajectoryExecutor
from .trajectory_exec import filter_place_poses
from .trajectory_exec import interpolate_pose
from .trajectory_exec import time_parameterize
