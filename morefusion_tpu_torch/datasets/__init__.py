"""Datasets of the port: model banks, the pose-estimation example factory
and its synthetic frame source, the reindexed and packed stores, and the
training transform (numpy and cv2 on the host). The YCB-Video bank and
datasets are imported on first use (``YCBVideoModels`` etc.), as in the
JAX package."""

# flake8: noqa: F401

from .background_composite import BackgroundComposite
from .base import ConcatDataset
from .base import DatasetBase
from .base import ModelsBase
from .base import VoxelGrid
from .external_results import load_posecnn_mat
from .external_results import load_results_json
from .instance_segmentation import SyntheticInstanceSegmentationDataset
from .instance_segmentation import frame_to_class_label
from .instance_segmentation import frame_to_masks
from .packed import PackedPoseDataset
from .packed import derive_transfer_arrays
from .packed import has_transfer_arrays
from .packed import is_packed
from .packed import pack_reindexed
from .procedural import ProceduralModels
from .rgbd_pose_estimation.base import RGBDPoseEstimationDatasetBase
from .rgbd_pose_estimation.frame_directory import FrameDirectoryDataset
from .rgbd_pose_estimation.frame_directory import save_frame
from .rgbd_pose_estimation.reindex import rebuild_meta
from .rgbd_pose_estimation.reindex import reindex
from .rgbd_pose_estimation.reindexed import RGBDPoseEstimationDatasetReIndexed
from .rgbd_pose_estimation.reindexed import RandomSamplingDataset
from .rgbd_pose_estimation.synthetic import SyntheticRGBDPoseEstimationDataset
from .transform import Transform
from . import ycb_video


def __getattr__(name):
    # ``datasets.YCBVideoModels`` etc. at the package's top level, as the
    # reference's ``morefusion/datasets/__init__.py``
    if name in (
        "YCBVideoModels",
        "YCBVideoDataset",
        "YCBVideoSyntheticDataset",
        "YCBVideoRGBDPoseEstimationDataset",
    ):
        return getattr(ycb_video, name)
    raise AttributeError(name)
