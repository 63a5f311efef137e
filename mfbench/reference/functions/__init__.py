"""Frozen copies of the port's differentiable functions."""

# flake8: noqa: F401

from .loss import average_distance_both
from .loss import densefusion_confidence_loss
from .tdf import pseudo_occupancy_voxelization
from .transforms import transform_points
from .transforms import transformation_matrix
