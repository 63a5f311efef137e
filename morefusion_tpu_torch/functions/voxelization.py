"""Point voxelization (scatter-mean, scatter-max) and trilinear voxel-grid
interpolation.

Port of ``morefusion_tpu/functions/voxelization.py``. Grids are
channels-last ``(B, X, Y, Z, C)`` at these function boundaries. The
scatter-mean and the interpolation take bf16 values. Where JAX sums bf16 values in bf16, the scatter-mean here sums
them in fp32 and casts the mean to bf16: a bf16 ``index_add_`` on the card
adds in a run-dependent order and loses bits.
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


def _voxel_ids(points, batch_indices, batch_size, origin, pitch, dims):
    """``(linear voxel id (P,) int64, valid (P,), n_voxels)``: each point's
    nearest voxel; NaN and out-of-bounds points go to the dump id
    ``n_voxels``."""
    X, Y, Z = dims
    device = points.device
    finite = ~torch.isnan(points).any(dim=-1)
    points = torch.nan_to_num(points)
    origin = torch.as_tensor(origin, dtype=points.dtype, device=device)
    pitch = torch.as_tensor(pitch, dtype=points.dtype, device=device)
    idx = torch.round((points - origin) / pitch).to(torch.int64)
    dims_t = torch.tensor([X, Y, Z], device=device)
    valid = ((idx >= 0) & (idx < dims_t)).all(dim=-1) & finite
    n_voxels = batch_size * X * Y * Z
    lin = ((batch_indices.to(torch.int64) * X + idx[:, 0]) * Y
           + idx[:, 1]) * Z + idx[:, 2]
    lin = torch.where(valid, lin, torch.full_like(lin, n_voxels))
    return lin, valid, n_voxels


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
    ``(B, X, Y, Z, C)`` in ``values.dtype``. NaN and out-of-bounds points
    are dropped; each voxel is the mean of the points that land in it (0 if
    none), summed in fp32 at least.
    """
    X, Y, Z = _dims3(dimensions)
    P, C = values.shape
    device = values.device
    lin, valid, n_voxels = _voxel_ids(points, batch_indices, batch_size,
                                      origin, pitch, (X, Y, Z))
    acc = torch.promote_types(values.dtype, torch.float32)
    sums = values.new_zeros((n_voxels + 1, C), dtype=acc).index_add(
        0, lin, values.to(acc))
    counts = torch.zeros(n_voxels + 1, dtype=torch.int32, device=device)
    counts = counts.index_add(0, lin, valid.to(torch.int32))
    sums, counts = sums[:-1], counts[:-1]
    denom = counts.clamp_min(1).to(acc)
    grid = (sums / denom[:, None]).to(values.dtype).reshape(
        batch_size, X, Y, Z, C)
    if return_counts:
        return grid, counts.reshape(batch_size, X, Y, Z)
    return grid


def max_voxelization_3d(
    values: torch.Tensor,
    points: torch.Tensor,
    batch_indices: torch.Tensor,
    intensities: torch.Tensor,
    *,
    batch_size: int,
    origin,
    pitch,
    dimensions,
    return_indices: bool = False,
):
    """Scatter-max by intensity: each voxel keeps the features of its
    maximum-intensity point, the lowest index winning ties.

    ``values (P, C)``, ``points (P, 3)``, ``batch_indices (P,)``,
    ``intensities (P,)`` -> ``(B, X, Y, Z, C)`` (0 where no point lands),
    and with ``return_indices`` the winner's index ``(B, X, Y, Z)`` int32
    (-1 where none). NaN and out-of-bounds points are dropped. The grid
    holds the winners' ``values`` as they are, so the gradient goes to
    winning points only.
    """
    X, Y, Z = _dims3(dimensions)
    P, C = values.shape
    device = values.device
    lin, valid, n_voxels = _voxel_ids(points, batch_indices, batch_size,
                                      origin, pitch, (X, Y, Z))
    masked = torch.where(valid, intensities,
                         torch.full_like(intensities, float("-inf")))
    seg_max = torch.full((n_voxels + 1,), float("-inf"),
                         dtype=intensities.dtype, device=device)
    seg_max = seg_max.scatter_reduce(0, lin, masked, "amax")[:-1]
    is_winner = valid & (intensities >= seg_max[lin.clamp_max(n_voxels - 1)])
    ids = torch.arange(P, device=device)
    winner = torch.full((n_voxels + 1,), P, dtype=torch.int64, device=device)
    winner = winner.scatter_reduce(
        0, lin, torch.where(is_winner, ids, P), "amin")[:-1]
    has_winner = winner < P
    # each winning point writes its voxel's row; the rest go to the dump
    # row. A scatter, not a gather of ``values`` at every voxel: the
    # gradient is then a gather back to the points, with no accumulation
    # into a default row that all empty voxels would share
    wins = valid & (winner[lin.clamp_max(n_voxels - 1)] == ids)
    rows = torch.where(wins, lin, n_voxels)[:, None].expand(P, C)
    grid = values.new_zeros((n_voxels + 1, C)).scatter(0, rows, values)
    grid = grid[:-1].reshape(batch_size, X, Y, Z, C)
    if return_indices:
        indices = torch.where(has_winner, winner, -1).to(torch.int32)
        return grid, indices.reshape(batch_size, X, Y, Z)
    return grid


_CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def interpolate_voxel_grid(grid, points, batch_indices) -> torch.Tensor:
    """Trilinear sample of ``grid (B, X, Y, Z, C)`` at ``points (P, 3)`` in
    voxel units; out-of-bounds corners contribute 0. Returns ``(P, C)`` in
    the grid's dtype (the weights are cast to it), differentiable w.r.t. the
    grid and the points."""
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


def interpolate_voxel_grid_sorted(grid, points,
                                  batch_indices) -> torch.Tensor:
    """:func:`interpolate_voxel_grid` under the name of the JAX package's
    variant, whose backward sorts the corner contributions by voxel so that
    the grid's gradient is summed in one order on every run. The plain
    backward here already is: autograd scatters the gather's gradient with
    ``index_put_(accumulate=True)``, which on the card sorts the indices
    and sums each voxel's contributions in that order."""
    return interpolate_voxel_grid(grid, points, batch_indices)
