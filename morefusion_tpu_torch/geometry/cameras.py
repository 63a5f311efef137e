"""Camera-pose math: look-at, spherical sampling, projection, and the
OpenGL camera convention.

Own copy of ``morefusion_tpu/geometry/cameras.py`` (reference
``morefusion/geometry/{look_at,points_from_angles,
uniform_points_on_sphere,project_to_camera}.py``).
"""

from __future__ import annotations

import typing

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


def uniform_points_on_sphere(angle_sampling: int, radius: float = 1.0):
    """Grid of (elevation x azimuth) samples on a sphere, one sample kept
    at each pole."""
    elevation = np.linspace(-90, 90, angle_sampling)
    azimuth = np.linspace(-180, 180, angle_sampling, endpoint=False)
    elevation, azimuth = np.meshgrid(elevation, azimuth)

    # at the poles azimuth is degenerate: keep a single sample per pole
    for pole in (-90, 90):
        keep = elevation != pole
        keep[np.argmin(keep)] = True
        azimuth = azimuth[keep]
        elevation = elevation[keep]

    elevation = elevation.flatten()
    azimuth = azimuth.flatten()
    distance = np.full((len(elevation),), radius, dtype=float)
    return points_from_angles(distance, elevation, azimuth)


def project_to_camera(
    points: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    image_shape: typing.Optional[tuple] = None,
):
    """3D camera-frame points -> (row, col) pixel coordinates, clipped to
    ``image_shape`` when given."""
    if points.ndim != 2:
        raise ValueError("points must be (N, 3)")
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    c = cx + (x / z * fx)
    r = cy + (y / z * fy)
    if image_shape is not None:
        r = np.clip(r, 0, image_shape[0] - 1)
        c = np.clip(c, 0, image_shape[1] - 1)
    return r, c


def _rot_x_180():
    R = np.eye(4)
    R[1, 1] = R[2, 2] = -1.0
    return R


def to_opengl_transform(transform=None):
    """Computer-vision camera pose (z forward, y down) -> OpenGL (z
    backward, y up): right-multiply by a 180-degree x rotation (reference
    ``morefusion/extra/_trimesh/utils.py:9-14``)."""
    T = np.eye(4) if transform is None else np.asarray(transform)
    return T @ _rot_x_180()


def from_opengl_transform(transform=None):
    """Inverse of :func:`to_opengl_transform` (the rotation is an
    involution)."""
    T = np.eye(4) if transform is None else np.asarray(transform)
    return T @ _rot_x_180()
