"""Scatter-mean voxelization and trilinear voxel-grid interpolation.

Port of ``morefusion_tpu/functions/voxelization.py``
(``average_voxelization_3d`` and ``interpolate_voxel_grid``). Grids are
channels-last ``(B, X, Y, Z, C)`` at these function boundaries.
"""

from __future__ import annotations

import torch


def _dims3(dimensions):
    if isinstance(dimensions, int):
        return (dimensions,) * 3
    dims = tuple(int(d) for d in dimensions)
    if len(dims) != 3:
        raise ValueError(f"dimensions must have 3 entries, got {dims}")
    return dims


def average_voxelization_3d(
    values: torch.Tensor,
    points: torch.Tensor,
    batch_indices: torch.Tensor,
    *,
    batch_size: int,
    origin,
    pitch,
    dimensions,
    return_counts: bool = False,
):
    """Scatter-mean point features into their nearest voxels.

    ``values (P, C)``, ``points (P, 3)``, ``batch_indices (P,)`` ->
    ``(B, X, Y, Z, C)``. NaN and out-of-bounds points are dropped; each
    voxel is the mean of the points that land in it (0 if none).
    """
    X, Y, Z = _dims3(dimensions)
    P, C = values.shape
    device = values.device
    finite = ~torch.isnan(points).any(dim=-1)
    points = torch.nan_to_num(points)
    origin = torch.as_tensor(origin, dtype=points.dtype, device=device)
    pitch = torch.as_tensor(pitch, dtype=points.dtype, device=device)
    idx = torch.round((points - origin) / pitch).to(torch.int64)
    dims = torch.tensor([X, Y, Z], device=device)
    valid = ((idx >= 0) & (idx < dims)).all(dim=-1) & finite
    n_voxels = batch_size * X * Y * Z
    lin = ((batch_indices.to(torch.int64) * X + idx[:, 0]) * Y
           + idx[:, 1]) * Z + idx[:, 2]
    lin = torch.where(valid, lin, torch.full_like(lin, n_voxels))
    sums = values.new_zeros((n_voxels + 1, C)).index_add(0, lin, values)
    counts = torch.zeros(n_voxels + 1, dtype=torch.int32, device=device)
    counts = counts.index_add(0, lin, valid.to(torch.int32))
    sums, counts = sums[:-1], counts[:-1]
    denom = counts.clamp_min(1).to(values.dtype)
    grid = (sums / denom[:, None]).reshape(batch_size, X, Y, Z, C)
    if return_counts:
        return grid, counts.reshape(batch_size, X, Y, Z)
    return grid


_CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def interpolate_voxel_grid(grid, points, batch_indices) -> torch.Tensor:
    """Trilinear sample of ``grid (B, X, Y, Z, C)`` at ``points (P, 3)`` in
    voxel units; out-of-bounds corners contribute 0. Returns ``(P, C)``,
    differentiable w.r.t. the grid and the points."""
    B, X, Y, Z, C = grid.shape
    lo = torch.floor(points)
    frac = points - lo
    lo = lo.to(torch.int64)
    offsets = torch.tensor(_CORNERS, device=grid.device)  # (8, 3)
    corners = lo[:, None, :] + offsets[None]  # (P, 8, 3)
    w = torch.where(offsets[None] == 1, frac[:, None, :],
                    1.0 - frac[:, None, :])
    weights = torch.prod(w, dim=-1)  # (P, 8)
    dims = torch.tensor([X, Y, Z], device=grid.device)
    in_bounds = ((corners >= 0) & (corners < dims)).all(dim=-1)
    safe = torch.minimum(corners.clamp_min(0), dims - 1)
    b = batch_indices.to(torch.int64)[:, None]
    gathered = grid[b, safe[..., 0], safe[..., 1], safe[..., 2]]  # (P, 8, C)
    weights = torch.where(in_bounds, weights, torch.zeros_like(weights))
    return torch.einsum("pkc,pk->pc", gathered, weights.to(gathered.dtype))
