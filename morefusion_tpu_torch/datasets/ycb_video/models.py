"""YCB-Video CAD asset bank (real data, when present on disk).

Own copy of ``morefusion_tpu/datasets/ycb_video/models.py`` (reference
``morefusion/datasets/ycb_video/models.py:13-115``). Expects the standard
``YCB_Video_Models`` layout (``<root>/<class_name>/textured_simple.obj``
and ``points.xyz``) under ``$MOREFUSION_TPU_DATA/ycb_video/
YCB_Video_Models``, or ``root_dir``. The binvox / trimesh derivations are
``extra/meshio.py``'s: z-parity solid voxelization at 48^3 and EDT inside
distances, cached to ``solid_voxels.npz`` next to the meshes (a read-only
directory recomputes them on each build).

Without the dataset, use ``ProceduralModels``: the same interface,
analytic assets.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ...extra import meshio
from ...utils.provenance import get_data_path
from ..base import ModelsBase, VoxelGrid
from .class_names import class_names as ycb_class_names


class YCBVideoModels(ModelsBase):
    _solid_dim = 48

    def __init__(self, root_dir: str = None):
        self._root_dir = root_dir or get_data_path(
            "ycb_video", "YCB_Video_Models"
        )
        if not os.path.isdir(self._root_dir):
            raise IOError(
                f"YCB_Video_Models not found at {self._root_dir}; "
                "set MOREFUSION_TPU_DATA or use ProceduralModels()"
            )

    @property
    def root_dir(self):
        return self._root_dir

    @property
    def class_names(self):
        return ycb_class_names

    def get_cad_file(self, class_id) -> str:
        name = self.class_names[int(class_id)]
        return os.path.join(self._root_dir, name, "textured_simple.obj")

    @functools.lru_cache(maxsize=None)
    def get_mesh(self, class_id):
        """``(vertices (V, 3) float64, faces (F, 3) int32)``."""
        return meshio.load_obj(self.get_cad_file(class_id))

    @functools.lru_cache(maxsize=None)
    def get_pcd(self, class_id) -> np.ndarray:
        """``points.xyz``, else 4000 area-weighted surface samples (seed
        0), float32."""
        name = self.class_names[int(class_id)]
        xyz = os.path.join(self._root_dir, name, "points.xyz")
        if os.path.exists(xyz):
            return meshio.load_xyz(xyz).astype(np.float32)
        vertices, faces = self.get_mesh(class_id)
        return meshio.sample_surface(vertices, faces, 4000).astype(
            np.float32
        )

    @functools.lru_cache(maxsize=None)
    def get_solid_voxel_grid(self, class_id) -> VoxelGrid:
        name = self.class_names[int(class_id)]
        cache = os.path.join(self._root_dir, name, "solid_voxels.npz")
        if os.path.exists(cache):
            data = np.load(cache)
            return VoxelGrid(
                data["points"], float(data["pitch"]), data["origin"],
                inside_distance=data["inside_distance"],
            )
        vertices, faces = self.get_mesh(class_id)
        occ, pitch, origin = meshio.solid_voxelize(
            vertices, faces, self._solid_dim
        )
        idx = np.argwhere(occ)
        points = idx * pitch + origin
        inside = meshio.inside_distance_from_occupancy(occ, pitch)
        try:
            np.savez_compressed(
                cache, points=points, pitch=pitch, origin=origin,
                inside_distance=inside,
            )
        except OSError:
            pass  # a read-only dataset directory: recompute next time
        return VoxelGrid(points, pitch, origin, inside_distance=inside)

    def get_sdf(self, class_id):
        grid = self.get_solid_voxel_grid(class_id)
        return grid.points, grid.inside_distance

    @functools.lru_cache(maxsize=None)
    def get_bbox_diagonal(self, class_id) -> float:
        pcd = self.get_pcd(class_id)
        extents = pcd.max(axis=0) - pcd.min(axis=0)
        return float(np.linalg.norm(extents))
