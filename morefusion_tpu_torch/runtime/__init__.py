"""Serving nodes of the port (``morefusion_tpu.runtime``): the pose node, the
segmentation node and the scene pipeline with its fusion, tracking and object
mapping."""

# flake8: noqa: F401

from ..models.segmentation import SegmentationNode
from .fusion import OccupancyFusion
from .object_mapping import ObjectMapping
from .object_mapping import ObjectTrack
from .pipeline import ScenePipeline
from .pose_estimation import PoseEstimationNode
from .tracking import is_detected_mask_too_small
from .tracking import mask_to_bbox
from .tracking import track_instance_id
