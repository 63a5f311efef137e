"""Model-bank contract of the port.

Own copy of ``VoxelGrid`` and of the part of ``ModelsBase`` that training
and the scene pipeline use, from ``morefusion_tpu/datasets/base.py``: a
model bank exposes per-class CAD assets (surface point cloud, SDF, solid
voxel grid, voxel pitch).
"""

from __future__ import annotations

import numpy as np


class VoxelGrid:
    """Solid voxelization result: occupied voxel centers + metadata.

    Stands in for the reference's binvox-backed
    ``trimesh.voxel.VoxelGrid`` (only ``.points`` and pitch/origin are used
    downstream).
    """

    def __init__(self, points, pitch, origin, inside_distance=None):
        self.points = np.asarray(points)
        self.pitch = float(pitch)
        self.origin = np.asarray(origin)
        #: inside-positive distance per point (the reference's SDF
        #: convention from trimesh.proximity.signed_distance)
        self.inside_distance = (
            None if inside_distance is None else np.asarray(inside_distance)
        )


class ModelsBase:
    """Per-class CAD asset bank."""

    @property
    def class_names(self):
        raise NotImplementedError

    def get_pcd(self, class_id) -> np.ndarray:
        """(N, 3) surface points of the CAD model."""
        raise NotImplementedError

    def get_sdf(self, class_id):
        """(points (N, 3), inside-positive distance (N,)) for solid points."""
        raise NotImplementedError

    def get_solid_voxel_grid(self, class_id) -> VoxelGrid:
        raise NotImplementedError

    def get_bbox_diagonal(self, class_id) -> float:
        raise NotImplementedError

    def get_voxel_pitch(self, dimension, class_id) -> float:
        """Reference: ``bbox_diagonal / dimension``
        (``morefusion/datasets/ycb_video/models.py:113-115``)."""
        return self.get_bbox_diagonal(class_id) / dimension
