"""Camera poses: look-at and spherical sampling.

Own copy of ``look_at`` and ``points_from_angles`` from
``morefusion_tpu/geometry/cameras.py``.
"""

from __future__ import annotations

import numpy as np

from .transform import compose_transform


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def look_at(eye, target=None, up=None) -> np.ndarray:
    """Camera pose (T_cam2world) looking from ``eye`` toward ``target``.

    Camera z-axis points at the target; default up is (0, 0, -1).
    """
    eye = np.asarray(eye, dtype=float)
    target = (
        np.zeros(3) if target is None else np.asarray(target, dtype=float)
    )
    up = (
        np.array([0.0, 0.0, -1.0]) if up is None else np.asarray(up, dtype=float)
    )
    if not eye.shape == target.shape == up.shape == (3,):
        raise ValueError("eye, target and up must be 3-vectors")

    z_axis = _normalize(target - eye)
    x_axis = _normalize(np.cross(up, z_axis))
    y_axis = _normalize(np.cross(z_axis, x_axis))
    R = np.vstack((x_axis, y_axis, z_axis))
    return compose_transform(R=R.T, t=eye)


def points_from_angles(distance, elevation, azimuth, is_degree: bool = True):
    """Spherical (distance, elevation, azimuth) -> Cartesian points."""
    distance = np.asarray(distance, dtype=float)
    elevation = np.asarray(elevation, dtype=float)
    azimuth = np.asarray(azimuth, dtype=float)
    if is_degree:
        elevation = np.radians(elevation)
        azimuth = np.radians(azimuth)
    if not distance.shape == elevation.shape == azimuth.shape:
        raise ValueError("distance, elevation and azimuth differ in shape")
    if distance.ndim not in (0, 1):
        raise ValueError("angles must be scalars or 1-D")
    return np.stack(
        [
            distance * np.cos(elevation) * np.sin(azimuth),
            -distance * np.cos(elevation) * np.cos(azimuth),
            distance * np.sin(elevation),
        ]
    ).transpose()
