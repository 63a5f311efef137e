"""Truncated distance function and pseudo-occupancy voxelization.

Port of ``morefusion_tpu/functions/tdf.py``. The per-voxel nearest-point
search is ``ops/min_dist.py`` (the CUDA kernel on the card, its plain
version on the CPU); its gradient is the two segment sums of the JAX
package's ``_min_dist_bwd``, done with ``index_add_``: the TPU kernel has no
backward kernel either. ``truncated_distance_function_scatter`` is the
neighbourhood-bounded segment-min of the reference's kernel, kept as a
cross-check as in JAX (stock ``scatter_reduce``, no kernel of its own).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import min_dist as _min_dist_ops


class _MinDist(torch.autograd.Function):
    """Per-lane ``(distance, winner index, winner payload)`` per voxel.

    ``points (B, P, 3)`` world frame, ``valid (B, P)``, ``payload (B, P)``
    int32, ``pitch (B,)``, ``origin (B, 3)``. Distances are in world units;
    only ``points`` gets a gradient, and only from the voxels it wins.
    """

    @staticmethod
    def forward(ctx, points, valid, payload, pitch, origin, dims):
        ip = (points - origin[:, None, :]) / pitch[:, None, None]
        valid = valid & ~torch.isnan(ip).any(dim=-1)
        ip = torch.nan_to_num(ip).contiguous()
        d2, arg, pay = _min_dist_ops.min_dist_voxels(
            ip, valid.contiguous(), payload.contiguous(), dims
        )
        dist = pitch[:, None] * torch.sqrt(d2.clamp_min(1e-12))
        ctx.dims = dims
        ctx.save_for_backward(points, pitch, origin, dist, arg)
        ctx.mark_non_differentiable(arg, pay)
        return dist, arg, pay

    @staticmethod
    def backward(ctx, g_dist, _g_arg, _g_pay):
        points, pitch, origin, dist, arg = ctx.saved_tensors
        B, P, _ = points.shape
        centers = _min_dist_ops.voxel_centers(ctx.dims, points.device,
                                              points.dtype)
        # (B, V, 3) world-frame voxel centres
        cw = origin[:, None, :] + centers[None] * pitch[:, None, None]
        hit = (arg >= 0) & torch.isfinite(dist)
        # d dist / d p_w = (p_w - c_v) / dist, split so that the backward
        # is two segment sums and no (B, V)-row gather of points:
        #   dL/dp_w = p_w * sum_v(g / d) - sum_v(g * c_v / d)
        a = torch.where(hit, g_dist / dist.clamp_min(1e-12),
                        torch.zeros_like(dist))  # (B, V)
        lane = torch.arange(B, device=points.device)[:, None] * (P + 1)
        seg = (torch.where(hit, arg.to(torch.int64), P) + lane).reshape(-1)
        A = a.new_zeros(B * (P + 1)).index_add_(0, seg, a.reshape(-1))
        Bv = a.new_zeros((B * (P + 1), 3)).index_add_(
            0, seg, (a[..., None] * cw).reshape(-1, 3))
        A = A.reshape(B, P + 1)[:, :P]
        Bv = Bv.reshape(B, P + 1, 3)[:, :P]
        # NaN input points get zero gradients (their A and B are zero)
        g_points = torch.nan_to_num(points) * A[..., None] - Bv
        return g_points, None, None, None, None, None


def truncated_distance_function(
    points: torch.Tensor,
    *,
    pitch,
    origin,
    dims,
    truncation,
    return_indices: bool = False,
    point_mask: Optional[torch.Tensor] = None,
    payload_q: Optional[torch.Tensor] = None,
    return_payload: bool = False,
):
    """Per-voxel distance to the nearest point, truncated at ``truncation``.

    ``points (P, 3)``, or batched ``(B, P, 3)`` with per-lane ``pitch
    (B,)``, ``origin (B, 3)`` and ``truncation (B,)``. Returns the
    ``(X, Y, Z)`` or ``(B, X, Y, Z)`` field, and with ``return_indices`` /
    ``return_payload`` the winner's index / payload (``-1`` where no point is
    closer than the truncation).
    """
    X, Y, Z = (int(d) for d in dims)
    batched = points.dim() == 3
    dtype, device = points.dtype, points.device
    if not batched:
        points = points[None]
    B, P, _ = points.shape

    def lane(x, shape):
        x = torch.as_tensor(x, dtype=dtype, device=device)
        return x.reshape(shape) if batched else x.reshape(1, *shape[1:])

    pitch_t = lane(pitch, (B,))
    origin_t = lane(origin, (B, 3))
    trunc_t = lane(truncation, (B,))
    valid = (torch.ones((B, P), dtype=torch.bool, device=device)
             if point_mask is None else point_mask.reshape(B, P))
    if payload_q is None:
        payload_q = torch.zeros((B, P), dtype=torch.int32, device=device)
    payload_q = payload_q.reshape(B, P).to(torch.int32)

    dist, arg, payload = _MinDist.apply(
        points, valid, payload_q, pitch_t, origin_t, (X, Y, Z)
    )  # (B, V)
    trunc_b = trunc_t[:, None]
    out_shape = (-1, X, Y, Z) if batched else (X, Y, Z)
    tdf = torch.minimum(dist, trunc_b).reshape(out_shape)
    if not (return_indices or return_payload):
        return tdf
    hit = (dist.detach() < trunc_b) & (arg >= 0)
    out = (tdf,)
    if return_indices:
        out += (torch.where(hit, arg, -1).reshape(out_shape),)
    if return_payload:
        out += (torch.where(hit, payload, -1).reshape(out_shape),)
    return out


def truncated_distance_function_scatter(
    points: torch.Tensor,
    *,
    pitch,
    origin,
    dims,
    truncation,
    return_indices: bool = False,
    ksize: Optional[int] = None,
):
    """The truncated distance of :func:`truncated_distance_function`, found
    only within a ``ksize^3`` neighbourhood of each point's nearest voxel
    (default ``ceil(truncation / pitch)``, made odd), as the reference's
    kernel: ``points (P, 3)`` -> ``(X, Y, Z)``, and with ``return_indices``
    the winner's index (-1 where none; the lowest point index on a tie).
    Voxels beyond the neighbourhood read ``truncation``."""
    dtype, device = points.dtype, points.device
    X, Y, Z = (int(d) for d in dims)
    n_voxels = X * Y * Z
    P = points.shape[0]
    pitch_t = torch.as_tensor(pitch, dtype=dtype, device=device)
    trunc_t = torch.as_tensor(truncation, dtype=dtype, device=device)
    if ksize is None:
        ksize = int(math.ceil(float(truncation) / float(pitch)))
    if ksize % 2 == 0:
        ksize += 1
    r = torch.arange(ksize, device=device) - ksize // 2
    offsets = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                          dim=-1).reshape(-1, 3)  # (K, 3)
    K = offsets.shape[0]

    origin_t = torch.as_tensor(origin, dtype=dtype, device=device)
    ip = (points - origin_t) / pitch_t
    vox = torch.round(ip).to(torch.int64)[:, None, :] + offsets[None]
    dims_t = torch.tensor([X, Y, Z], device=device)
    in_bounds = ((vox >= 0) & (vox < dims_t)).all(dim=-1)
    delta = ip[:, None, :] - vox.to(dtype)
    dist = pitch_t * torch.sqrt(torch.sum(delta**2, dim=-1))  # (P, K)
    valid = in_bounds & (dist < trunc_t)
    lin = (vox[..., 0] * Y + vox[..., 1]) * Z + vox[..., 2]
    seg = torch.where(valid, lin, n_voxels).reshape(-1)
    dist_flat = torch.where(valid, dist, trunc_t).reshape(-1)
    tdf = torch.full((n_voxels + 1,), float("inf"), dtype=dtype,
                     device=device)
    tdf = tdf.scatter_reduce(0, seg, dist_flat, "amin")[:-1]
    tdf = torch.minimum(tdf, trunc_t).reshape(X, Y, Z)
    if not return_indices:
        return tdf

    big = P * K
    tdf_flat = tdf.detach().reshape(-1)
    is_winner = (seg < n_voxels) & (
        dist_flat.detach() <= tdf_flat[seg.clamp_max(n_voxels - 1)])
    pairs = torch.arange(big, device=device)
    winner = torch.full((n_voxels + 1,), big, dtype=torch.int64,
                        device=device)
    winner = winner.scatter_reduce(
        0, seg, torch.where(is_winner, pairs, big), "amin")[:-1]
    point_idx = torch.where(winner < big, winner // K, -1).to(torch.int32)
    return tdf, point_idx.reshape(X, Y, Z)


def pseudo_occupancy_voxelization(
    points: torch.Tensor,
    sdf: torch.Tensor,
    *,
    pitch,
    origin,
    dims,
    threshold=1,
    sdf_offset=0,
    point_mask: Optional[torch.Tensor] = None,
):
    """Points and per-point SDF -> ``(grid_uniform, grid_surface,
    grid_inside)`` occupancy grids, each ``(X, Y, Z)`` or ``(B, X, Y, Z)``.

    ``grid = 1 - tdf / (threshold * pitch)``; the inside weight is the
    winning point's SDF (quantized to 14 bits and carried as the kernel's
    payload, ``+ sdf_offset``, clipped at 0, max-normalized); the surface
    weight flips the positive inside weights to ``1 - w``.
    """
    batched = points.dim() == 3
    dtype, device = points.dtype, points.device
    pitch_t = torch.as_tensor(pitch, dtype=dtype, device=device)
    # a Python threshold stays a scalar operand: an upload of it would
    # synchronise the stream on every ICC iteration
    truncation = pitch_t * threshold

    sdf = sdf.to(torch.float32)
    sdf_max = sdf.amax(dim=-1, keepdim=True)
    sdf_scale = sdf_max.clamp_min(torch.finfo(torch.float32).tiny)
    sdf_q = torch.round(sdf / sdf_scale * 16383.0).clamp(0, 16383)
    sdf_q = sdf_q.to(torch.int32)

    tdf, payload = truncated_distance_function(
        points,
        pitch=pitch,
        origin=origin,
        dims=dims,
        truncation=truncation,
        return_payload=True,
        point_mask=point_mask,
        payload_q=sdf_q,
    )
    trunc_b = truncation[:, None, None, None] if batched else truncation
    grid = 1.0 - tdf / trunc_b

    hit = payload >= 0
    scale_b = sdf_scale[:, 0][:, None, None, None] if batched else sdf_scale[0]
    picked = payload.to(grid.dtype) / 16383.0 * scale_b
    weight_inside = torch.where(hit, picked, -1.0) + sdf_offset
    neg = weight_inside < 0
    weight_inside = torch.where(neg, 0.0, weight_inside)
    if batched:
        wmax = weight_inside.amax(dim=(1, 2, 3), keepdim=True)
    else:
        wmax = weight_inside.amax()
    weight_inside = weight_inside / wmax.clamp_min(
        torch.finfo(grid.dtype).tiny)
    weight_surface = torch.where(neg, weight_inside, 1.0 - weight_inside)
    return grid, grid * weight_surface, grid * weight_inside
