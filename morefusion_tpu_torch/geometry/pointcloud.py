"""Point-cloud helpers: back-projection and voxel down-sampling.

Own copy of ``pointcloud_from_depth`` and ``voxel_down_sample`` from
``morefusion_tpu/geometry/pointcloud.py``.
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
