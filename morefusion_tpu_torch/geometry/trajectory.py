"""Camera trajectories: greedy path ordering and spline interpolation.

Own copy of ``morefusion_tpu/geometry/trajectory.py``: ``sort``,
``sort_by`` and ``interpolate``.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate


def _pairwise_sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) squared euclidean distances."""
    d = a[:, None, :] - b[None, :, :]
    return np.einsum("ijk,ijk->ij", d, d)


def sort(points: np.ndarray) -> np.ndarray:
    """Greedy nearest-neighbour path through the points.

    Starts at ``points[0]``; each step moves to the nearest unvisited
    point. Returns ``len(points) - 1`` waypoints (the final point is
    dropped, as the reference's camera-path callers expect).
    """
    points = np.asarray(points, dtype=float)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError("points must be (N, 3)")

    n = len(points)
    dist = _pairwise_sq(points, points)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n - 1, dtype=int)
    order[0] = 0
    visited[0] = True
    for i in range(1, n - 1):
        row = np.where(visited, np.inf, dist[order[i - 1]])
        order[i] = int(np.argmin(row))
        visited[order[i]] = True
    return points[order]


def sort_by(points: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Order ``points`` by greedily assigning the nearest remaining point
    to each ``key`` point in turn."""
    points = np.asarray(points)
    key = np.asarray(key)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError("points must be (N, 3)")
    if key.ndim != 2 or key.shape[1] != 3:
        raise ValueError("key must be (N, 3)")
    if len(points) != len(key):
        raise ValueError("points and key differ in length")

    dist = _pairwise_sq(key.astype(float), points.astype(float))
    taken = np.zeros(len(points), dtype=bool)
    order = np.empty(len(key), dtype=int)
    for i in range(len(key)):
        row = np.where(taken, np.inf, dist[i])
        order[i] = int(np.argmin(row))
        taken[order[i]] = True
    return points[order]


def interpolate(keypoints: np.ndarray, n_points: int) -> np.ndarray:
    """Spline interpolation through the keypoints (cubic when possible)."""
    k = min(3, len(keypoints) - 1)
    tck, _ = scipy.interpolate.splprep(keypoints.T, s=0, k=k)
    points = scipy.interpolate.splev(np.linspace(0, 1, n_points), tck)
    return np.array(points, dtype=np.float64).T
