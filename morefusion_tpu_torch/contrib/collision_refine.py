"""Joint multi-object collision-based pose refinement (ICC).

Port of ``morefusion_tpu/contrib/collision_refine.py``. ICC (iterative
collision check) refines all object poses of a scene together: Adam on the
loss ``penalty - reward`` with

  reward  = sum(grid_surface * grid_target) / sum(grid_target)
  penalty = sum(grid_inside * grid_nontarget_empty') / sum(grid_inside)

where ``grid_nontarget_empty'`` also holds the other objects' inside grids.
Every loss evaluation builds the objects' pseudo-occupancy grids, and so
runs the min-distance kernel once (``ops/min_dist.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..functions.tdf import pseudo_occupancy_voxelization
from ..functions.transforms import transform_points, transformation_matrix
from ..geometry import (
    quaternion_from_matrix,
    quaternion_matrix_np,
    translation_from_matrix,
)


def _axis_weights(o_i, pitch_i, o_j, pitch_j, V):
    """``(N, N, V_out, V_src)`` trilinear hat weights of one axis for every
    pair (i, j): frame i's voxel centres sampled in frame j's grid.
    Out-of-range rows are all zero."""
    idx = torch.arange(V, dtype=o_i.dtype, device=o_i.device)
    src = ((o_i[:, None, None] + idx * pitch_i[:, None, None]
            - o_j[None, :, None]) / pitch_j[None, :, None])  # (N, N, V)
    d = torch.abs(src[..., None] - idx)
    return torch.clamp(1.0 - d, 0.0, 1.0)


def _resample_grids(grid, pitch, origin, voxel_dim):
    """``(N, N, V, V, V)``: object j's grid resampled at frame i's voxel
    centres, for every pair (i, j). Both grids are axis-aligned, so the
    trilinear resample is three separable 1-D interpolations."""
    V = voxel_dim
    wx, wy, wz = (
        _axis_weights(origin[:, a], pitch, origin[:, a], pitch, V)
        for a in range(3)
    )
    g = torch.einsum("ijax,jxyz->ijayz", wx, grid)
    g = torch.einsum("ijby,ijayz->ijabz", wy, g)
    return torch.einsum("ijcz,ijabz->ijabc", wz, g)


def icc_loss(
    quaternions,  # (N, 4)
    translations,  # (N, 3)
    points,  # (N, M, 3) solid CAD points (padded)
    sdf,  # (N, M) inside-positive distances
    point_mask,  # (N, M) bool
    pitch,  # (N,)
    origin,  # (N, 3)
    grid_target,  # (N, V, V, V)
    grid_nontarget_empty,  # (N, V, V, V)
    obj_mask,  # (N,) bool, False for padded object slots
    *,
    voxel_dim: int = 32,
    threshold: float = 2.0,
    sdf_offset: float = 0.0,
    cross_mode: str = "resample",
):
    """The ICC loss. ``cross_mode="resample"``: each object's inside grid is
    voxelized once in its own frame and the other objects' occupancy in
    frame i is their grids resampled into it (inside weights normalized per
    object). ``"exact"`` is not ported yet."""
    if cross_mode == "exact":
        raise NotImplementedError("cross_mode='exact' is not ported yet")
    if cross_mode != "resample":
        raise ValueError(f"unknown cross_mode: {cross_mode}")
    N = points.shape[0]
    dims = (voxel_dim,) * 3
    T = transformation_matrix(quaternions, translations)
    moved = transform_points(points, T)  # (N, M, 3)
    valid = point_mask & obj_mask[:, None]
    _, grid_s, grid_i = pseudo_occupancy_voxelization(
        moved, sdf, pitch=pitch, origin=origin, dims=dims,
        threshold=threshold, sdf_offset=sdf_offset, point_mask=valid,
    )
    pairs = _resample_grids(grid_i, pitch, origin, voxel_dim)
    eye = torch.eye(N, dtype=torch.bool, device=points.device)
    keep = ~eye & obj_mask[None, :]
    pairs = torch.where(keep[:, :, None, None, None], pairs, 0.0)
    grid_other = pairs.amax(dim=1)
    gne = torch.maximum(grid_nontarget_empty, grid_other)

    om = obj_mask[:, None, None, None]
    grid_s = torch.where(om, grid_s, 0.0)
    grid_i = torch.where(om, grid_i, 0.0)
    g_t = torch.where(om, grid_target, 0.0)
    reward = torch.sum(grid_s * g_t) / torch.sum(g_t).clamp_min(1e-16)
    penalty = torch.sum(grid_i * gne) / torch.sum(grid_i).clamp_min(1e-16)
    return penalty - reward


def _dequantize(grid):
    if grid.dtype == torch.uint8:
        return grid.to(torch.float32) * (1.0 / 255.0)
    return grid.to(torch.float32)


def refine_collision(
    quaternions,
    translations,
    points,
    sdf,
    point_mask,
    pitch,
    origin,
    grid_target,
    grid_nontarget_empty,
    obj_mask=None,
    *,
    voxel_dim: int = 32,
    threshold: float = 2.0,
    sdf_offset: float = 0.0,
    iterations: int = 30,
    alpha: float = 0.01,
    cross_mode: str = "resample",
):
    """Jointly refine all object poses with Adam.

    The translation group's rate is ``0.1 * alpha``. Early stop is the ROS
    node's plateau rule: stop after 3 iterations in a row whose last 10 loss
    changes are all below 0.009. Returns ``(quaternions, translations, losses, n_iter)``:
    the best-loss iterate of the run, one loss per iteration (after the stop,
    the loss at the frozen parameters), and the number of iterations that
    updated the parameters. Grids may be uint8 (``/255``) or float.
    """
    device = points.device
    N = quaternions.shape[0]
    if obj_mask is None:
        obj_mask = torch.ones((N,), dtype=torch.bool, device=device)
    grid_target = _dequantize(grid_target)
    grid_nontarget_empty = _dequantize(grid_nontarget_empty)

    q = quaternions.detach().to(torch.float32).clone().requires_grad_(True)
    t = translations.detach().to(torch.float32).clone().requires_grad_(True)
    # torch.optim.Adam matches optax.adam: eps outside the square root
    opt = torch.optim.Adam(
        [{"params": [q], "lr": alpha}, {"params": [t], "lr": alpha * 0.1}],
        betas=(0.9, 0.999), eps=1e-8,
    )

    def loss_fn():
        return icc_loss(
            q, t, points, sdf, point_mask, pitch, origin, grid_target,
            grid_nontarget_empty, obj_mask, voxel_dim=voxel_dim,
            threshold=threshold, sdf_offset=sdf_offset,
            cross_mode=cross_mode,
        )

    best_loss = math.inf
    best_q, best_t = q.detach().clone(), t.detach().clone()
    losses = []
    last = math.inf
    deltas = [math.inf] * 10
    n_passed = 0
    n_iter = 0
    while len(losses) < iterations:
        loss = loss_fn()
        value = float(loss.detach())  # the plateau rule decides on the host
        if value < best_loss:
            best_loss = value
            best_q, best_t = q.detach().clone(), t.detach().clone()
        losses.append(value)
        deltas = deltas[1:] + [abs(last - value)]
        last = value
        n_passed = n_passed + 1 if max(deltas) < 0.009 else 0
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        n_iter += 1
        if n_passed >= 3 and len(losses) < iterations:
            # frozen from here on: every later entry is the loss at the
            # frozen parameters, evaluated once
            with torch.no_grad():
                value = float(loss_fn())
            if value < best_loss:
                best_loss = value
                best_q, best_t = q.detach().clone(), t.detach().clone()
            losses += [value] * (iterations - len(losses))
    return best_q, best_t, torch.tensor(losses, dtype=torch.float32), n_iter


class IterativeCollisionCheck:
    """Host-side wrapper: pads per-object lists into the refiner's arrays.

    The object axis is padded to a power of two; padded slots are masked out
    of the loss. Objects with more than ``max_points`` points keep a
    random subset (seeded by the object's slot).
    """

    def __init__(
        self,
        transforms,  # list of (4, 4) initial poses
        points,  # list of (M_i, 3) solid points
        sdf,  # list of (M_i,)
        pitch,  # list/array of float
        origin,  # list of (3,)
        grid_target,  # (N, V, V, V)
        grid_nontarget_empty,  # (N, V, V, V)
        voxel_dim: int = 32,
        threshold: float = 2.0,
        sdf_offset: float = 0.0,
        max_points: Optional[int] = None,
        cross_mode: str = "resample",
        device="cuda",
    ):
        N = len(transforms)
        Np = 1 << (N - 1).bit_length() if N > 0 else N
        self._n = N
        self._device = torch.device(device)
        obj_mask = np.zeros((Np,), bool)
        obj_mask[:N] = True
        M = max_points or max(len(p) for p in points)
        q = np.tile(np.array([1, 0, 0, 0], np.float32), (Np, 1))
        q[:N] = np.stack([quaternion_from_matrix(T) for T in transforms])
        t = np.zeros((Np, 3), np.float32)
        t[:N] = np.stack([translation_from_matrix(T) for T in transforms])
        pts = np.zeros((Np, M, 3), np.float32)
        sd = np.zeros((Np, M), np.float32)
        mask = np.zeros((Np, M), bool)
        for i, (p, s) in enumerate(zip(points, sdf)):
            k = min(len(p), M)
            if len(p) > M:
                keep = np.random.RandomState(i).permutation(len(p))[:M]
                p, s = p[keep], s[keep]
            pts[i, :k] = p[:k]
            sd[i, :k] = s[:k]
            mask[i, :k] = True
        pitch_a = np.ones((Np,), np.float32)
        pitch_a[:N] = np.asarray(pitch, np.float32)
        origin_a = np.zeros((Np, 3), np.float32)
        origin_a[:N] = np.asarray(origin, np.float32)

        def grids(g):
            g = np.asarray(g)
            dtype = np.uint8 if g.dtype == np.uint8 else np.float32
            out = np.zeros((Np,) + g.shape[1:], dtype)
            out[:N] = g.astype(dtype)
            return out

        dev = self._device
        self._q = q
        self._t = t
        self._arrays = {
            name: torch.from_numpy(a).to(dev)
            for name, a in dict(
                points=pts, sdf=sd, point_mask=mask, pitch=pitch_a,
                origin=origin_a, grid_target=grids(grid_target),
                grid_nontarget_empty=grids(grid_nontarget_empty),
                obj_mask=obj_mask,
            ).items()
        }
        self._kw = dict(voxel_dim=voxel_dim, threshold=threshold,
                        sdf_offset=sdf_offset, cross_mode=cross_mode)

    def refine(self, iterations: int = 30, alpha: float = 0.01):
        """Refine; returns ``(transforms (N, 4, 4), losses, n_iter)``."""
        q, t, losses, n_iter = refine_collision(
            torch.from_numpy(self._q).to(self._device),
            torch.from_numpy(self._t).to(self._device),
            **self._arrays, **self._kw, iterations=iterations, alpha=alpha,
        )
        self._q = q.cpu().numpy()
        self._t = t.cpu().numpy()
        return self.transforms, losses.numpy(), n_iter

    @property
    def transforms(self):
        out = []
        for q, t in zip(self._q[: self._n], self._t[: self._n]):
            T = quaternion_matrix_np(q)
            T[:3, 3] = t
            out.append(T)
        return np.stack(out)
