"""Point-cloud helpers: back-projection, normals, voxel down-sampling.

Own copy of ``morefusion_tpu/geometry/pointcloud.py`` (reference
``morefusion/geometry/pointcloud_from_depth.py``,
``estimate_pointcloud_normals.py``). The unorganized normals are a PCA of
each point's neighbourhood (sklearn's KDTree, imported inside the
function) where the reference calls Open3D.
"""

from __future__ import annotations

import numpy as np


def pointcloud_from_depth(
    depth: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    depth_type: str = "z",
) -> np.ndarray:
    """Pinhole back-projection of a depth map to an organized point cloud.

    NaN depth stays NaN in the output (``(H, W, 3)``).
    """
    if depth_type not in ("z", "euclidean"):
        raise ValueError(f"unexpected depth_type: {depth_type}")
    if depth.dtype.kind != "f":
        raise ValueError("depth must be float (meters)")

    rows, cols = depth.shape
    c, r = np.meshgrid(np.arange(cols), np.arange(rows), sparse=True)
    valid = ~np.isnan(depth)
    z = np.where(valid, depth, np.nan)
    x = np.where(valid, z * (c - cx) / fx, np.nan)
    y = np.where(valid, z * (r - cy) / fy, np.nan)
    pc = np.dstack((x, y, z))

    if depth_type == "euclidean":
        norm = np.linalg.norm(pc, axis=2)
        pc = pc * (z / norm)[:, :, None]
    return pc


def estimate_pointcloud_normals(points: np.ndarray) -> np.ndarray:
    """Estimate normals of an organized ``(H, W, 3)`` or unorganized
    ``(N, 3)`` point cloud."""
    if points.ndim == 3:
        return _normals_organized(points)
    elif points.ndim == 2:
        return _normals_unorganized(points)
    raise ValueError("points shape must be either (H, W, 3) or (N, 3)")


def _normals_organized(points: np.ndarray) -> np.ndarray:
    """8-direction cross-product normals on the organized grid: offsets at
    distance 2, the direction pair with the smallest combined edge length
    wins (the reference's neighbourhood scheme)."""
    if points.shape[2] != 3:
        raise ValueError("points must be (H, W, 3)")

    d = 2
    H, W = points.shape[:2]
    padded = np.pad(
        points,
        pad_width=((d, d), (d, d), (0, 0)),
        mode="constant",
        constant_values=np.nan,
    )
    lookups = np.array(
        [(-d, 0), (-d, d), (0, d), (d, d), (d, 0), (d, -d), (0, -d), (-d, -d)]
    )

    j, i = np.meshgrid(np.arange(W), np.arange(H))
    i1, j1 = i + d, j + d
    p1 = padded[i1, j1]

    k = np.arange(8)
    lk = lookups[k]
    p2 = padded[i1[None] + lk[:, 0, None, None],
                j1[None] + lk[:, 1, None, None]]
    lk2 = lookups[(k + 2) % 8]
    p3 = padded[i1[None] + lk2[:, 0, None, None],
                j1[None] + lk2[:, 1, None, None]]

    diff = np.linalg.norm(p2 - p1, axis=3) + np.linalg.norm(p3 - p1, axis=3)
    diff[np.isnan(diff)] = np.inf
    best = np.argmin(diff, axis=0)

    normals = np.cross(p2[best, i, j] - p1[i, j], p3[best, i, j] - p1[i, j])
    normals /= np.linalg.norm(normals, axis=2, keepdims=True)
    return normals


def _normals_unorganized(
    points: np.ndarray, radius: float = 0.1, max_nn: int = 30
) -> np.ndarray:
    """PCA-of-neighbourhood normals of the non-NaN points (in place of
    Open3D's ``estimate_normals``)."""
    import sklearn.neighbors

    if points.shape[1] != 3:
        raise ValueError("points must be (N, 3)")
    nonnan = ~np.isnan(points).any(axis=1)
    pts = points[nonnan]
    tree = sklearn.neighbors.KDTree(pts)
    k = min(max_nn, len(pts))
    dist, idx = tree.query(pts, k=k)
    neigh = pts[idx]  # (N, k, 3)
    # neighbours beyond the radius become the point itself (zero
    # contribution to the covariance)
    mask = dist <= radius
    neigh = np.where(mask[..., None], neigh, pts[:, None, :])
    mean = neigh.mean(axis=1, keepdims=True)
    centered = neigh - mean
    cov = np.einsum("nki,nkj->nij", centered, centered)
    _, eigvecs = np.linalg.eigh(cov)
    return eigvecs[:, :, 0]  # the smallest eigenvalue's direction


def voxel_down_sample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel-grid down-sampling: the mean of the points in each occupied
    voxel, NaN rows dropped. Voxels come in ``np.unique``'s order (sorted by
    their integer coordinates), which ICP's lowest-index tie rule sees."""
    points = np.asarray(points)
    points = points[~np.isnan(points).any(axis=1)]
    if len(points) == 0:
        return points
    coords = np.floor(points / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(
        coords, axis=0, return_inverse=True, return_counts=True
    )
    sums = np.zeros((len(counts), 3), dtype=points.dtype)
    np.add.at(sums, inverse, points)
    return sums / counts[:, None]
