"""NumPy ADD / ADD-S.

Port of ``morefusion_tpu/metrics/average_distance.py``. The JAX copy finds
ADD-S's nearest points with ``sklearn.neighbors.KDTree``; the port uses
``scipy.spatial.cKDTree``, also exact.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def _transform_points(points, transform, translate=True):
    out = points @ transform[:3, :3].T
    if translate:
        out = out + transform[:3, 3]
    return out


def _average_distance(points, transform1, transform2, translate=True):
    assert points.shape == (points.shape[0], 3)
    assert transform1.shape == (4, 4)
    assert transform2.shape == (4, 4)
    points1 = _transform_points(points, transform1, translate=translate)
    points2 = _transform_points(points, transform2, translate=translate)

    add = np.linalg.norm(points1 - points2, axis=1).mean()

    _, indices = cKDTree(points2).query(points1, k=1)
    add_s = np.linalg.norm(points1 - points2[indices], axis=1).mean()
    return add, add_s


def average_distance(points, transform1, transform2, translate=True):
    """Batched ADD and ADD-S.

    ``points``: list of ``(N_i, 3)`` CAD point clouds; ``transform1`` and
    ``transform2``: lists of ``(4, 4)`` poses. Returns ``(adds, add_ss)``,
    two ``(B,)`` float arrays.
    """
    assert isinstance(points, list)
    batch_size = len(points)
    assert len(transform1) == batch_size
    assert len(transform2) == batch_size

    adds = np.zeros((batch_size,), dtype=float)
    add_ss = np.zeros((batch_size,), dtype=float)
    for i in range(batch_size):
        adds[i], add_ss[i] = _average_distance(
            points[i], transform1[i], transform2[i], translate=translate
        )
    return adds, add_ss
