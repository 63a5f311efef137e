"""Model-bank contract of the port.

Own copy of ``VoxelGrid`` and of the part of ``ModelsBase`` that training
uses, from ``morefusion_tpu/datasets/base.py``: a model bank exposes
per-class CAD assets (surface point cloud, solid voxel grid).
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

    def get_solid_voxel_grid(self, class_id) -> VoxelGrid:
        raise NotImplementedError
