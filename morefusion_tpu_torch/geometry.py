"""NumPy host helpers the port needs, kept as its own copies.

Copies of ``morefusion_tpu/geometry/bbox.py::masks_to_bboxes``, of
``quaternion_matrix_np``, ``quaternion_from_matrix`` and
``translation_from_matrix`` from ``morefusion_tpu/geometry/transform.py``,
and of ``voxel_down_sample`` from ``morefusion_tpu/geometry/pointcloud.py``.
Quaternions are ``(w, x, y, z)``.
"""

from __future__ import annotations

import numpy as np


def masks_to_bboxes(masks: np.ndarray) -> np.ndarray:
    """Boolean mask image(s) -> ``(y1, x1, y2, x2)`` boxes.

    ``(H, W)`` -> ``(4,)``; ``(N, H, W)`` -> ``(N, 4)``. Empty masks give
    all-zero boxes.
    """
    masks = np.asarray(masks)
    if masks.dtype != bool or masks.ndim not in (2, 3):
        raise ValueError("masks must be a bool array of 2 or 3 dimensions")
    ndim = masks.ndim
    if ndim == 2:
        masks = masks[None]
    bboxes = np.zeros((len(masks), 4), dtype=np.float64)
    for i, mask in enumerate(masks):
        rows = mask.any(axis=1)
        if not rows.any():
            continue
        y_idx = np.flatnonzero(rows)
        x_idx = np.flatnonzero(mask.any(axis=0))
        bboxes[i] = y_idx[0], x_idx[0], y_idx[-1] + 1, x_idx[-1] + 1
    return bboxes[0] if ndim == 2 else bboxes


def quaternion_matrix_np(quaternion) -> np.ndarray:
    """Quaternion -> 4x4 rotation matrix (normalizing)."""
    q = np.asarray(quaternion, dtype=np.float64)
    n = np.dot(q, q)
    if n < np.finfo(np.float64).eps:
        return np.eye(4)
    q = q * np.sqrt(2.0 / n)
    q = np.outer(q, q)
    return np.array([
        [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0.0],
        [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0.0],
        [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2], 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ])


def quaternion_from_matrix(matrix) -> np.ndarray:
    """4x4 (or 3x3) rotation matrix -> quaternion, by Shepperd's method."""
    M = np.asarray(matrix, dtype=np.float64)[:3, :3]
    t = np.trace(M)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (M[2, 1] - M[1, 2]) / s
        y = (M[0, 2] - M[2, 0]) / s
        z = (M[1, 0] - M[0, 1]) / s
    elif M[0, 0] >= M[1, 1] and M[0, 0] >= M[2, 2]:
        s = np.sqrt(1.0 + M[0, 0] - M[1, 1] - M[2, 2]) * 2.0
        w = (M[2, 1] - M[1, 2]) / s
        x = 0.25 * s
        y = (M[0, 1] + M[1, 0]) / s
        z = (M[0, 2] + M[2, 0]) / s
    elif M[1, 1] >= M[2, 2]:
        s = np.sqrt(1.0 + M[1, 1] - M[0, 0] - M[2, 2]) * 2.0
        w = (M[0, 2] - M[2, 0]) / s
        x = (M[0, 1] + M[1, 0]) / s
        y = 0.25 * s
        z = (M[1, 2] + M[2, 1]) / s
    else:
        s = np.sqrt(1.0 + M[2, 2] - M[0, 0] - M[1, 1]) * 2.0
        w = (M[1, 0] - M[0, 1]) / s
        x = (M[0, 2] + M[2, 0]) / s
        y = (M[1, 2] + M[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return -q if q[0] < 0 else q


def translation_from_matrix(matrix) -> np.ndarray:
    return np.asarray(matrix, dtype=np.float64)[:3, 3].copy()


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
