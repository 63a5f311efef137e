"""Procedural analytic-SDF model bank (21 YCB-like classes).

Own copy of ``morefusion_tpu/datasets/procedural.py::ProceduralModels``:
each class is a CSG composition of analytic SDF primitives with YCB-like
dimensions, and its surface point cloud, solid voxel grid and per-point
signed distances come from the closed-form field
(``extra/sdf_primitives.py``); the renderer (``extra/render.py``) reads its
shapes, colours and cached surface samples. Nothing is downloaded.
"""

from __future__ import annotations

import functools

import numpy as np

from ..extra.sdf_primitives import (
    Box,
    Capsule,
    Cylinder,
    Difference,
    Ellipsoid,
    Torus,
    Transformed,
    Union,
)
from .base import ModelsBase, VoxelGrid
from .ycb_video.class_names import class_names as ycb_class_names


def _t(shape, dx=0.0, dy=0.0, dz=0.0):
    T = np.eye(4)
    T[:3, 3] = [dx, dy, dz]
    return Transformed(shape, T)


def _rx90(shape):
    T = np.eye(4)
    T[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], dtype=float)
    return Transformed(shape, T)


def _build_shapes():
    """One analytic shape per YCB class id (1..21)."""
    mug_body = Cylinder(0.045, 0.08)
    mug_handle = _t(_rx90(Torus(0.03, 0.008)), dx=0.055)
    pitcher_body = Cylinder(0.054, 0.24)
    pitcher_handle = _t(_rx90(Torus(0.05, 0.012)), dx=0.06)
    drill_body = _rx90(Cylinder(0.023, 0.18))
    drill_grip = _t(Cylinder(0.018, 0.13), dz=-0.06)
    scissor_a = _t(Capsule(0.008, 0.17), dx=0.012)
    scissor_b = _t(Capsule(0.008, 0.17), dx=-0.012)
    clamp_a = Box((0.14, 0.03, 0.02))
    clamp_b = Box((0.03, 0.12, 0.02))
    xclamp_a = Box((0.18, 0.04, 0.025))
    xclamp_b = Box((0.04, 0.16, 0.025))
    bowl = Difference(
        Ellipsoid((0.08, 0.08, 0.055)),
        _t(Ellipsoid((0.072, 0.072, 0.05)), dz=0.015),
    )

    return {
        1: Cylinder(0.051, 0.14),  # master_chef_can
        2: Box((0.06, 0.158, 0.21)),  # cracker_box
        3: Box((0.038, 0.089, 0.175)),  # sugar_box
        4: Cylinder(0.033, 0.101),  # tomato_soup_can
        5: Ellipsoid((0.048, 0.029, 0.095)),  # mustard_bottle
        6: Cylinder(0.0425, 0.033),  # tuna_fish_can
        7: Box((0.035, 0.11, 0.089)),  # pudding_box
        8: Box((0.028, 0.085, 0.073)),  # gelatin_box
        9: Box((0.05, 0.097, 0.082)),  # potted_meat_can
        10: _rx90(Capsule(0.019, 0.15)),  # banana
        11: Union([pitcher_body, pitcher_handle]),  # pitcher_base
        12: Box((0.065, 0.098, 0.25)),  # bleach_cleanser
        13: bowl,  # bowl
        14: Union([mug_body, mug_handle]),  # mug
        15: Union([drill_body, drill_grip]),  # power_drill
        16: Box((0.085, 0.085, 0.2)),  # wood_block
        17: Union([scissor_a, scissor_b]),  # scissors
        18: Cylinder(0.0095, 0.121),  # large_marker
        19: Union([clamp_a, clamp_b]),  # large_clamp
        20: Union([xclamp_a, xclamp_b]),  # extra_large_clamp
        21: Box((0.05, 0.075, 0.05)),  # foam_brick
    }


# deterministic per-class base colors for the synthetic renderer
_COLORS = np.array(
    [
        [0, 0, 0],
        [200, 60, 60], [230, 180, 60], [240, 240, 130], [220, 70, 40],
        [230, 200, 40], [90, 140, 220], [170, 110, 60], [220, 100, 150],
        [120, 170, 220], [240, 220, 80], [80, 80, 200], [240, 240, 240],
        [200, 80, 80], [80, 180, 180], [60, 160, 70], [200, 160, 110],
        [230, 120, 40], [60, 60, 160], [110, 110, 110], [60, 60, 60],
        [180, 60, 40],
    ],
    dtype=np.uint8,
)


class ProceduralModels(ModelsBase):
    """Analytic-SDF stand-in for ``YCBVideoModels`` (zero assets needed)."""

    _n_surface_points = 4000
    _solid_dim = 48

    def __init__(self):
        self._shapes = _build_shapes()

    @property
    def class_names(self):
        return ycb_class_names

    def get_shape(self, class_id):
        return self._shapes[int(class_id)]

    def get_color(self, class_id):
        return _COLORS[int(class_id)]

    @functools.lru_cache(maxsize=None)
    def get_surface_samples(self, class_id, n_points):
        """Cached ``(points, normals)`` surface samples for the renderer,
        seeded with ``RandomState(class_id * 7919 + 13)``."""
        shape = self._shapes[int(class_id)]
        rng = np.random.RandomState(int(class_id) * 7919 + 13)
        pts = shape.sample_surface(int(n_points), rng)
        normals = shape.normals(pts)
        return pts, normals

    @functools.lru_cache(maxsize=None)
    def get_pcd(self, class_id):
        shape = self._shapes[int(class_id)]
        rng = np.random.RandomState(int(class_id))
        return shape.sample_surface(self._n_surface_points, rng).astype(
            np.float32
        )

    @functools.lru_cache(maxsize=None)
    def get_solid_voxel_grid(self, class_id):
        shape = self._shapes[int(class_id)]
        points, inside, pitch, origin = shape.solid_voxel_points(
            self._solid_dim
        )
        return VoxelGrid(points, pitch, origin, inside_distance=inside)

    def get_sdf(self, class_id):
        grid = self.get_solid_voxel_grid(class_id)
        return grid.points, grid.inside_distance

    def get_bbox_diagonal(self, class_id):
        return self._shapes[int(class_id)].bbox_diagonal
