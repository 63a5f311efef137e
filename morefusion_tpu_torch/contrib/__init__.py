"""Refiners of the port (``morefusion_tpu.contrib``)."""

# flake8: noqa: F401

from .collision_refine import IterativeCollisionCheck
from .collision_refine import icc_loss
from .collision_refine import refine_collision
from .icp import ICPRegistration
from .icp import gradient_icp
from .icp import icp_point_to_point
from .icp import icp_point_to_point_gated
from .occupancy_mapping import MultiInstanceOccupancyMapping
from .occupancy_mapping import SparseVoxelMap
from .occupancy_registration import OccupancyRegistration
from .occupancy_registration import register_occupancy
