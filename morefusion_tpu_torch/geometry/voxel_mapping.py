"""Simple dense RGB voxel map.

Own copy of ``morefusion_tpu/geometry/voxel_mapping.py`` (reference
``morefusion/geometry/voxel_mapping.py:6-76``): array accessors
(``occupied_points``, ``occupied_values``) in place of the reference's
trimesh drawing.
"""

from __future__ import annotations

import numpy as np


class VoxelMapping:
    def __init__(self, origin=None, pitch=None, voxel_dim=None, nchannel=None):
        self.origin = origin
        self.voxel_dim = voxel_dim
        self.pitch = pitch
        self.nchannel = nchannel
        self._matrix = None
        self._values = None

    @property
    def matrix(self) -> np.ndarray:
        if self._matrix is None:
            self._matrix = np.zeros((self.voxel_dim,) * 3, dtype=float)
        return self._matrix

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            self._values = np.zeros(
                (self.voxel_dim,) * 3 + (self.nchannel,), dtype=float
            )
        return self._values

    @property
    def voxel_bbox_extents(self) -> np.ndarray:
        return np.array((self.voxel_dim * self.pitch,) * 3, dtype=float)

    def add(self, points: np.ndarray, values: np.ndarray) -> None:
        """Mark the voxels containing ``points`` and store their values."""
        indices = ((points - self.origin) / self.pitch).round().astype(int)
        keep = ((indices >= 0) & (indices < self.voxel_dim)).all(axis=1)
        indices = indices[keep]
        if len(indices) == 0:
            return
        I, J, K = indices[:, 0], indices[:, 1], indices[:, 2]
        self.matrix[I, J, K] = True
        self.values[I, J, K] = values[keep]

    def occupied_indices(self) -> np.ndarray:
        return np.argwhere(self.matrix)

    def occupied_points(self) -> np.ndarray:
        """World-frame centers of occupied voxels."""
        return self.occupied_indices() * self.pitch + self.origin

    def occupied_values(self) -> np.ndarray:
        idx = self.occupied_indices()
        return self.values[idx[:, 0], idx[:, 1], idx[:, 2]]
