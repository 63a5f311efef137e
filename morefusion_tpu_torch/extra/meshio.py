"""Minimal mesh IO and mesh geometry (no trimesh dependency).

Own copy of ``morefusion_tpu/extra/meshio.py``, float64 NumPy on the host,
equal to it bit for bit (the per-ray loop of ``_ray_triangle_hits_z`` is
kept as it is). What the YCB-Video asset pipeline needs from
``textured_simple.obj`` / ``points.xyz`` files: vertex/face parsing,
surface sampling, and solid voxelization by watertight-mesh ray parity
(the reference's binvox role, ``morefusion/utils/get_binvox_file.py``);
plus the box, bin and tiling helpers of the reference's display code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (vertices (V, 3) float64, faces (F, 3) int32).

    Polygons are fan-triangulated; normals/texcoords ignored.
    """
    vertices = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append(
                    [float(parts[1]), float(parts[2]), float(parts[3])]
                )
            elif line.startswith("f "):
                idx = [
                    int(p.split("/")[0]) - 1 for p in line.split()[1:]
                ]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (
        np.asarray(vertices, dtype=np.float64),
        np.asarray(faces, dtype=np.int32),
    )


def load_xyz(path: str) -> np.ndarray:
    """Parse a whitespace-separated points file -> (N, 3)."""
    return np.loadtxt(path, dtype=np.float64)[:, :3]


def face_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)


def sample_surface(
    vertices: np.ndarray, faces: np.ndarray, n: int, rng=None
) -> np.ndarray:
    """Area-weighted uniform surface sampling."""
    rng = rng or np.random.RandomState(0)
    areas = face_areas(vertices, faces)
    probs = areas / areas.sum()
    face_idx = rng.choice(len(faces), size=n, p=probs)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    tri = vertices[faces[face_idx]]
    return tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])


def _ray_triangle_hits_z(vertices, faces, xy_points, eps=1e-12):
    """For +z rays from each (x, y, z=-inf): intersection z values.

    Vectorized Moller-Trumbore specialized to axis rays; returns a list of
    crossing-z arrays per query (used for parity tests / z-intervals).
    """
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    # project to xy for point-in-triangle tests (z-axis rays)
    d1 = v1[:, :2] - v0[:, :2]
    d2 = v2[:, :2] - v0[:, :2]
    denom = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    ok = np.abs(denom) > eps

    hits = []
    for q in xy_points:
        rel = q[None, :2] - v0[:, :2]
        u = (rel[:, 0] * d2[:, 1] - rel[:, 1] * d2[:, 0]) / np.where(
            ok, denom, 1.0
        )
        v = (d1[:, 0] * rel[:, 1] - d1[:, 1] * rel[:, 0]) / np.where(
            ok, denom, 1.0
        )
        inside = ok & (u >= 0) & (v >= 0) & (u + v <= 1)
        z = (
            v0[inside, 2]
            + u[inside] * (v1[inside, 2] - v0[inside, 2])
            + v[inside] * (v2[inside, 2] - v0[inside, 2])
        )
        hits.append(np.sort(z))
    return hits


def solid_voxelize(
    vertices: np.ndarray,
    faces: np.ndarray,
    dim: int = 48,
) -> Tuple[np.ndarray, float, np.ndarray]:
    """Watertight-mesh solid voxelization by z-ray parity counting.

    Returns (occupancy (dim, dim, dim) bool, pitch, origin) on a cube grid
    over the mesh bbox — the binvox role for real CAD assets.
    """
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    center = (lo + hi) / 2
    half = float((hi - lo).max()) / 2 * 1.02
    pitch = 2 * half / dim
    origin = center - half + pitch / 2

    xs = origin[0] + np.arange(dim) * pitch
    ys = origin[1] + np.arange(dim) * pitch
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    queries = np.stack([gx.ravel(), gy.ravel()], axis=1)

    occ = np.zeros((dim, dim, dim), dtype=bool)
    zs = origin[2] + np.arange(dim) * pitch
    hits = _ray_triangle_hits_z(vertices, faces, queries)
    for qi, z_cross in enumerate(hits):
        if len(z_cross) < 2:
            continue
        i, j = qi // dim, qi % dim
        # parity: inside between consecutive crossing pairs
        inside = np.searchsorted(z_cross, zs, side="left") % 2 == 1
        occ[i, j] = inside
    return occ, pitch, origin


def inside_distance_from_occupancy(
    occ: np.ndarray, pitch: float
) -> np.ndarray:
    """Inside-positive distance per occupied voxel via EDT (the reference's
    trimesh signed-distance role for solid points)."""
    import scipy.ndimage

    dist = scipy.ndimage.distance_transform_edt(occ) * pitch
    return dist[occ]


def box_mesh(extents, center=(0.0, 0.0, 0.0)):
    """Axis-aligned box as (vertices (8, 3), faces (12, 3))."""
    ex, ey, ez = (float(e) / 2.0 for e in extents)
    cx, cy, cz = center
    v = np.array(
        [
            [sx * ex + cx, sy * ey + cy, sz * ez + cz]
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ],
        dtype=np.float64,
    )
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        dtype=np.int32,
    )
    return v, f


def merge_meshes(meshes):
    """Concatenate [(vertices, faces), ...] into one (vertices, faces)."""
    verts, faces, off = [], [], 0
    for v, f in meshes:
        verts.append(np.asarray(v, np.float64))
        faces.append(np.asarray(f, np.int32) + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(faces)


def bin_model(extents, thickness):
    """Five-wall open-top bin mesh (reference
    ``morefusion/extra/_trimesh/utils.py:32-57``): two full-height x walls,
    two inset y walls, one bottom plate. Returns (vertices, faces)."""
    xl, yl, zl = extents
    t = thickness
    walls = [
        box_mesh((t, yl, zl), (xl / 2, 0, 0)),
        box_mesh((t, yl, zl), (-xl / 2, 0, 0)),
        box_mesh((xl, t, zl), (0, yl / 2 - t / 2, 0)),
        box_mesh((xl, t, zl), (0, -yl / 2 + t / 2, 0)),
        box_mesh((xl, yl, t), (0, 0, -zl / 2 + t / 2)),
    ]
    return merge_meshes(walls)


def tile_meshes(meshes, shape=None, spacing=None):
    """Lay out [(vertices, faces), ...] on a grid (reference
    ``extra.trimesh.tile_meshes`` display helper). Returns one merged
    (vertices, faces) with each mesh centered in its own cell."""
    n = len(meshes)
    if shape is None:
        cols = int(np.ceil(np.sqrt(n)))
        shape = (int(np.ceil(n / cols)), cols)
    if spacing is None:
        spacing = max(
            float(np.ptp(np.asarray(v), axis=0).max()) for v, _ in meshes
        ) * 1.2
    placed = []
    for k, (v, f) in enumerate(meshes):
        r, c = divmod(k, shape[1])
        v = np.asarray(v, np.float64)
        center = (v.min(axis=0) + v.max(axis=0)) / 2.0
        offset = np.array([c * spacing, -r * spacing, 0.0]) - center
        placed.append((v + offset, f))
    return merge_meshes(placed)
