"""Analytic signed-distance-field primitives and CSG composition.

Own copy of ``morefusion_tpu/extra/sdf_primitives.py`` (numpy only), the
shapes of the procedural model bank: solid voxel grids, per-point signed
distances and surface samples all come from the same closed-form field.

Convention: sdf < 0 inside, > 0 outside (flip for the reference's
inside-positive convention where needed).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


class SDFShape:
    """Base: analytic SDF + derived sampling utilities."""

    #: (3,) half-extents of a tight axis-aligned bounding box
    half_extents: np.ndarray

    def sdf(self, points: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # ---- derived ----------------------------------------------------

    @property
    def extents(self) -> np.ndarray:
        return 2.0 * np.asarray(self.half_extents)

    @property
    def bbox_diagonal(self) -> float:
        return float(np.linalg.norm(self.extents))

    def normals(self, points: np.ndarray, eps: float = 1e-4) -> np.ndarray:
        """Finite-difference SDF gradient (unit normals)."""
        n = np.zeros_like(points)
        for a in range(3):
            d = np.zeros(3)
            d[a] = eps
            n[:, a] = self.sdf(points + d) - self.sdf(points - d)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.maximum(norm, 1e-12)

    def sample_surface(self, n: int, rng=None) -> np.ndarray:
        """Surface samples via iterative SDF projection of volume samples."""
        rng = rng or np.random.RandomState(0)
        he = np.asarray(self.half_extents) * 1.2
        pts = rng.uniform(-he, he, (int(n * 1.5), 3))
        for _ in range(6):
            d = self.sdf(pts)
            pts = pts - d[:, None] * self.normals(pts)
        d = np.abs(self.sdf(pts))
        pts = pts[d < 1e-3 * max(1.0, self.bbox_diagonal)]
        if len(pts) >= n:
            return pts[:n]
        # top up by repeating (degenerate shapes only)
        reps = int(np.ceil(n / max(len(pts), 1)))
        return np.tile(pts, (reps, 1))[:n]

    def solid_voxel_points(
        self, dim: int = 32
    ) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray]:
        """Voxelize the interior on a dim^3 grid over the bbox.

        Returns:
          (points (M, 3), inside_distance (M,), pitch, origin) — points are
          occupied voxel centers; inside_distance is the reference-style
          *inside-positive* distance (= -sdf).
        """
        he = np.asarray(self.half_extents)
        pitch = float(2 * he.max() / dim) if he.max() > 0 else 1.0 / dim
        # cube grid centered at origin
        origin = -he.max() + pitch / 2 * np.ones(3)
        r = np.arange(dim) * pitch + origin[0]
        gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
        centers = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        d = self.sdf(centers)
        inside = d <= 0
        return centers[inside], -d[inside], pitch, origin


@dataclasses.dataclass
class Box(SDFShape):
    size: Tuple[float, float, float]

    def __post_init__(self):
        self.half_extents = np.asarray(self.size) / 2.0

    def sdf(self, points):
        q = np.abs(points) - self.half_extents
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
        inside = np.minimum(q.max(axis=1), 0.0)
        return outside + inside


@dataclasses.dataclass
class Ellipsoid(SDFShape):
    radii: Tuple[float, float, float]

    def __post_init__(self):
        self.half_extents = np.asarray(self.radii)

    def sdf(self, points):
        r = np.asarray(self.radii)
        k0 = np.linalg.norm(points / r, axis=1)
        k1 = np.linalg.norm(points / (r * r), axis=1)
        return k0 * (k0 - 1.0) / np.maximum(k1, 1e-12)


@dataclasses.dataclass
class Cylinder(SDFShape):
    """Axis along z."""

    radius: float
    height: float

    def __post_init__(self):
        self.half_extents = np.array(
            [self.radius, self.radius, self.height / 2.0]
        )

    def sdf(self, points):
        dxy = np.linalg.norm(points[:, :2], axis=1) - self.radius
        dz = np.abs(points[:, 2]) - self.height / 2.0
        d = np.stack([dxy, dz], axis=1)
        outside = np.linalg.norm(np.maximum(d, 0.0), axis=1)
        inside = np.minimum(d.max(axis=1), 0.0)
        return outside + inside


@dataclasses.dataclass
class Capsule(SDFShape):
    """Axis along z, total height = height + 2*radius."""

    radius: float
    height: float

    def __post_init__(self):
        self.half_extents = np.array(
            [self.radius, self.radius, self.height / 2.0 + self.radius]
        )

    def sdf(self, points):
        p = points.copy()
        p[:, 2] = p[:, 2] - np.clip(
            p[:, 2], -self.height / 2.0, self.height / 2.0
        )
        return np.linalg.norm(p, axis=1) - self.radius


@dataclasses.dataclass
class Torus(SDFShape):
    """In the xy-plane."""

    major_radius: float
    minor_radius: float

    def __post_init__(self):
        R, r = self.major_radius, self.minor_radius
        self.half_extents = np.array([R + r, R + r, r])

    def sdf(self, points):
        qx = np.linalg.norm(points[:, :2], axis=1) - self.major_radius
        q = np.stack([qx, points[:, 2]], axis=1)
        return np.linalg.norm(q, axis=1) - self.minor_radius


@dataclasses.dataclass
class Transformed(SDFShape):
    """Rigidly transformed child shape (T maps child frame -> this frame)."""

    shape: SDFShape
    T: np.ndarray  # (4, 4)

    def __post_init__(self):
        # conservative bbox: transform child's bbox corners
        he = np.asarray(self.shape.half_extents)
        corners = (
            np.array(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            )
            * he
        )
        moved = corners @ self.T[:3, :3].T + self.T[:3, 3]
        self.half_extents = np.abs(moved).max(axis=0)

    def sdf(self, points):
        R = self.T[:3, :3]
        t = self.T[:3, 3]
        local = (points - t) @ R  # R^-1 == R^T
        return self.shape.sdf(local)


@dataclasses.dataclass
class Union(SDFShape):
    shapes: Sequence[SDFShape]

    def __post_init__(self):
        hes = np.stack([np.asarray(s.half_extents) for s in self.shapes])
        self.half_extents = hes.max(axis=0)

    def sdf(self, points):
        return np.min(
            np.stack([s.sdf(points) for s in self.shapes]), axis=0
        )


@dataclasses.dataclass
class Difference(SDFShape):
    """base minus cut (approximate SDF: max(d_base, -d_cut))."""

    base: SDFShape
    cut: SDFShape

    def __post_init__(self):
        self.half_extents = np.asarray(self.base.half_extents)

    def sdf(self, points):
        return np.maximum(self.base.sdf(points), -self.cut.sdf(points))
