"""Datasets of the port: model banks, the pose-estimation example factory
and its synthetic frame source, the reindexed and packed stores, and the
training transform (numpy and cv2 on the host)."""

# flake8: noqa: F401

from .base import ConcatDataset
from .base import DatasetBase
from .base import ModelsBase
from .base import VoxelGrid
from .packed import PackedPoseDataset
from .packed import is_packed
from .packed import pack_reindexed
from .procedural import ProceduralModels
from .rgbd_pose_estimation.base import RGBDPoseEstimationDatasetBase
from .rgbd_pose_estimation.reindex import rebuild_meta
from .rgbd_pose_estimation.reindex import reindex
from .rgbd_pose_estimation.reindexed import RGBDPoseEstimationDatasetReIndexed
from .rgbd_pose_estimation.reindexed import RandomSamplingDataset
from .rgbd_pose_estimation.synthetic import SyntheticRGBDPoseEstimationDataset
from .transform import Transform
