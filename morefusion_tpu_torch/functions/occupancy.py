"""Differentiable soft occupancy grids.

Port of ``morefusion_tpu/functions/occupancy.py``: per voxel, the distance
in voxel units to the nearest point, mapped through
``clamp(threshold - d, 0, 1)``. The 1-D and 2-D grids are plain tensor
code, as in JAX. The 3-D grid takes its distance from ``tdf._MinDist``, so
that on the card it is the ``min_dist.cu`` kernel and on the CPU its plain
version, and no ``(X, Y, Z, P)`` tensor is built.
"""

from __future__ import annotations

import torch

from .tdf import _MinDist


def occupancy_grid_1d(points, *, pitch, origin, dims, threshold=1):
    """``points (P,)`` -> ``(X,)`` soft occupancy."""
    ip = (points - origin) / pitch
    centers = torch.arange(int(dims), dtype=points.dtype,
                           device=points.device)
    d_min = torch.abs(centers[:, None] - ip[None, :]).amin(dim=-1)
    return torch.clamp(threshold - d_min, 0.0, 1.0)


def occupancy_grid_2d(points, *, pitch, origin, dims, threshold=1):
    """``points (P, 2)``, ``origin (2,)``, ``dims (X, Y)`` -> ``(X, Y)``."""
    origin = torch.as_tensor(origin, dtype=points.dtype, device=points.device)
    ip = (points - origin) / pitch
    X, Y = (int(d) for d in dims)
    cx = torch.arange(X, dtype=points.dtype, device=points.device)
    cy = torch.arange(Y, dtype=points.dtype, device=points.device)
    dx = cx[:, None, None] - ip[None, None, :, 0]
    dy = cy[None, :, None] - ip[None, None, :, 1]
    d_min = torch.sqrt(dx**2 + dy**2).amin(dim=-1)
    return torch.clamp(threshold - d_min, 0.0, 1.0)


def occupancy_grid_3d(points, *, pitch, origin, dims, threshold=1):
    """Soft occupancy grid of a point cloud, differentiable in the points.

    ``points (P, 3)`` float32 world frame, ``pitch`` the voxel size,
    ``origin (3,)``, ``dims (X, Y, Z)`` -> ``(X, Y, Z)`` in [0, 1]: per
    voxel ``clamp(threshold - min_p |c_v - p_vox|, 0, 1)``.

    The points are taken to voxel units first and the distance comes back
    as ``sqrt(d2)`` of the nearest point, in voxel units, with no rounding
    through ``pitch``. As JAX's ``jnp.min``, one NaN point makes the whole
    grid NaN (a flag on the device, no read to the host).

    The gradient goes to each voxel's nearest point: on a tie between
    points the lowest index takes all of it, where JAX splits it equally.
    Where a voxel centre coincides with its point (``d = 0``), JAX's
    gradient is NaN and this one is finite (``d2`` is taken at least
    ``1e-12``).
    """
    device = points.device
    origin = torch.as_tensor(origin, dtype=points.dtype, device=device)
    ip = ((points - origin) / pitch).to(torch.float32)
    P = ip.shape[0]
    ones = torch.ones((1,), dtype=torch.float32, device=device)
    d, _, _ = _MinDist.apply(
        ip[None],
        torch.ones((1, P), dtype=torch.bool, device=device),
        torch.zeros((1, P), dtype=torch.int32, device=device),
        ones, torch.zeros((1, 3), dtype=torch.float32, device=device),
        tuple(int(x) for x in dims),
    )
    grid = torch.clamp(threshold - d[0], 0.0, 1.0).reshape(
        tuple(int(x) for x in dims))
    any_nan = torch.isnan(points).any()
    return torch.where(any_nan, torch.full_like(grid, float("nan")), grid)
