"""Differentiable geometry ops of the port (``morefusion_tpu.functions``)."""

# flake8: noqa: F401

from .knn import nn
from .knn import pairwise_sq_dist
from .loss import average_distance
from .loss import average_distance_both
from .loss import densefusion_confidence_loss
from .occupancy import occupancy_grid_1d
from .occupancy import occupancy_grid_2d
from .occupancy import occupancy_grid_3d
from .tdf import pseudo_occupancy_voxelization
from .tdf import truncated_distance_function
from .transforms import compose_transform
from .transforms import quaternion_matrix
from .transforms import transform_points
from .transforms import transformation_matrix
from .transforms import translation_matrix
from .voxelization import average_voxelization_3d
from .voxelization import interpolate_voxel_grid
from .voxelization import interpolate_voxel_grid_sorted
from .voxelization import max_voxelization_3d
