"""Host pose conversions: frozen copies from
``morefusion_tpu_torch/geometry/transform.py``.
"""

from __future__ import annotations

import numpy as np


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
