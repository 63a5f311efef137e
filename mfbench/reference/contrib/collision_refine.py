"""Joint multi-object collision-based pose refinement (ICC).

Port of ``morefusion_tpu/contrib/collision_refine.py``. ICC (iterative
collision check) refines all object poses of a scene together: Adam on the
loss ``penalty - reward`` with

  reward  = sum(grid_surface * grid_target) / sum(grid_target)
  penalty = sum(grid_inside * grid_nontarget_empty') / sum(grid_inside)

where ``grid_nontarget_empty'`` also holds the other objects' inside grids.
Every loss evaluation builds the objects' pseudo-occupancy grids, and so
runs the min-distance kernel (``ops/min_dist.py``) once, or twice in the
exact cross mode, whose second launch voxelizes all other objects' points
into each object's frame (``N`` lanes of ``N * M`` points). The Adam loop and
its plateau rule run on the device, as the JAX package's ``lax.scan`` does:
``IterativeCollisionCheck.refine_async`` queues it without a read to the
host, and ``resolve`` reads the result back once.
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
    return_parts: bool = False,
):
    """The ICC loss. ``cross_mode``:

    - ``"resample"``: each object's inside grid is voxelized once in its own
      frame, and the other objects' occupancy in frame i is their grids
      resampled into it (inside weights normalized per object);
    - ``"exact"``: the reference's formulation. The points of all objects
      but i are voxelized into frame i, one lane of ``N * M`` points per
      object (a shared max-normalization of their inside weights). As in
      the JAX package, this voxelization takes no ``sdf_offset``.

    With ``return_parts`` returns ``(loss, (penalty_i, reward_i))``, the
    per-object ``(N,)`` parts.
    """
    N, M, _ = points.shape
    dims = (voxel_dim,) * 3
    T = transformation_matrix(quaternions, translations)
    moved = transform_points(points, T)  # (N, M, 3)
    valid = point_mask & obj_mask[:, None]
    _, grid_s, grid_i = pseudo_occupancy_voxelization(
        moved, sdf, pitch=pitch, origin=origin, dims=dims,
        threshold=threshold, sdf_offset=sdf_offset, point_mask=valid,
    )
    device = points.device
    if cross_mode == "resample":
        pairs = _resample_grids(grid_i, pitch, origin, voxel_dim)
        eye = torch.eye(N, dtype=torch.bool, device=device)
        keep = ~eye & obj_mask[None, :]
        pairs = torch.where(keep[:, :, None, None, None], pairs, 0.0)
        grid_other = pairs.amax(dim=1)
    elif cross_mode == "exact":
        # every lane holds all N * M points; lane i masks its own object's.
        # The payload's scale is the max of the lane's whole sdf, masked
        # points included, as JAX's broadcast sdf gives it
        flat_pts = moved.reshape(1, N * M, 3).expand(N, N * M, 3)
        flat_sdf = sdf.reshape(1, N * M).expand(N, N * M)
        owner = torch.arange(N, device=device).repeat_interleave(M)
        others = valid.reshape(1, N * M) & (
            owner[None, :] != torch.arange(N, device=device)[:, None])
        _, _, grid_other = pseudo_occupancy_voxelization(
            flat_pts, flat_sdf, pitch=pitch, origin=origin, dims=dims,
            threshold=threshold, point_mask=others,
        )
    else:
        raise ValueError(f"unknown cross_mode: {cross_mode}")
    gne = torch.maximum(grid_nontarget_empty, grid_other)

    om = obj_mask[:, None, None, None]
    grid_s = torch.where(om, grid_s, 0.0)
    grid_i = torch.where(om, grid_i, 0.0)
    g_t = torch.where(om, grid_target, 0.0)
    reward = torch.sum(grid_s * g_t) / torch.sum(g_t).clamp_min(1e-16)
    penalty = torch.sum(grid_i * gne) / torch.sum(grid_i).clamp_min(1e-16)
    if return_parts:
        ax = (1, 2, 3)
        reward_i = (torch.sum(grid_s * g_t, ax)
                    / torch.sum(g_t, ax).clamp_min(1e-16))
        penalty_i = (torch.sum(grid_i * gne, ax)
                     / torch.sum(grid_i, ax).clamp_min(1e-16))
        return penalty - reward, (penalty_i, reward_i)
    return penalty - reward


def _dequantize(grid):
    if grid.dtype == torch.uint8:
        return grid.to(torch.float32) * (1.0 / 255.0)
    return grid.to(torch.float32)


# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# The plateau rule (the ROS node's LossObserver): stop after 3 iterations in
# a row whose last 10 |loss changes| are all below 0.009. The first change is
# taken against an infinite "last loss", so the window first holds 10 finite
# changes at iteration 10, the rule fires at iteration 12 at the earliest,
# and the parameters can be frozen from iteration 13 on.
_WINDOW, _PASSES, _PLATEAU = 10, 3, 0.009


def _adam_constants(iterations: int, device):
    """``(decay, 1 - decay, bias)`` for the two moments, made on the device
    (an upload would synchronise the stream): ``(2, 1, 1)``, ``(2, 1, 1)``
    and ``(iterations, 2, 1, 1)``. ``bias[k]`` is ``1 - decay ** (k + 1)``,
    taken in float64 as JAX takes it with x64 on, and cast to float32."""
    decay = torch.full((2, 1, 1), _B1, dtype=torch.float64, device=device)
    decay[1] = _B2
    c = torch.arange(1, iterations + 1, dtype=torch.float64, device=device)
    bias = 1.0 - decay ** c[:, None, None, None]
    return tuple(x.to(torch.float32) for x in (decay, 1.0 - decay, bias))


def _neg_rates(iterations: int, N: int, alpha: float, alpha_decay: bool,
               device):
    """``(iterations, N, 7)`` float32: step k's negated rate of each
    parameter, made on the device. Quaternion columns at ``alpha``,
    translation columns at ``0.1 * alpha``; with ``alpha_decay`` each is
    ``optax.cosine_decay_schedule(rate, iterations)`` at the count before
    step k's update, taken in float64 and cast to float32."""
    rate = torch.full((7,), alpha, dtype=torch.float64, device=device)
    rate[4:] = alpha * 0.1
    if alpha_decay:
        count = torch.arange(iterations, dtype=torch.float64, device=device)
        cosine = 0.5 * (1.0 + torch.cos(
            math.pi * count.clamp_max(iterations) / iterations))
        rate = rate * cosine[:, None]
    else:
        rate = rate.expand(iterations, 7)
    return (-rate).to(torch.float32)[:, None, :].expand(iterations, N, 7)


def _adam_step(state, g, decay, one_minus_decay, bias, neg_lr):
    """One step of ``optax.adam`` (eps outside the square root,
    ``eps_root=0``) on the packed state ``(3, ...)`` of parameters, first
    and second moments: returns the new state. ``bias`` is ``(2, 1, 1)``,
    the two moments' bias corrections for this step; ``neg_lr`` holds each
    parameter's negated rate. Each operation rounds as optax's does."""
    moments = one_minus_decay * torch.stack([g, g * g]) + decay * state[1:]
    m_hat, v_hat = moments / bias
    p = state[0] + neg_lr * (m_hat / (torch.sqrt(v_hat) + _EPS))
    return torch.cat([p[None], moments])


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
    early_stop: bool = True,
    cross_mode: str = "resample",
    alpha_decay: bool = False,
):
    """Jointly refine all object poses with Adam, every iteration on the
    device.

    Mirrors the JAX package's ``lax.scan``: always ``iterations`` steps, no
    read to the host in any of them. The translation group's rate is
    ``0.1 * alpha``; ``alpha_decay`` decays both to 0 on a cosine over the
    ``iterations`` (``optax.cosine_decay_schedule``). With ``early_stop``, the plateau rule freezes the
    parameters and the Adam state from the step it fires; later steps
    evaluate the loss at the frozen parameters. Returns ``(quaternions,
    translations, losses, n_iter)`` as tensors on the inputs' device: the
    best-loss iterate, one loss per iteration and the number of iterations
    that updated the parameters (0-d int32). Grids may be uint8 (``/255``)
    or float.

    Each object's quaternion and translation are one row of 7 parameters,
    and the Adam state is one ``(3, N, 7)`` tensor, so that a step and its
    freeze are a few launches for all objects. Before the rule can fire the
    loop keeps no stop flag; the iterates and losses go to buffers, and the
    best iterate is picked once, after the loop.
    """
    device = points.device
    N = quaternions.shape[0]
    if obj_mask is None:
        obj_mask = torch.ones((N,), dtype=torch.bool, device=device)
    grid_target = _dequantize(grid_target)
    grid_nontarget_empty = _dequantize(grid_nontarget_empty)
    decay, one_minus_decay, bias = _adam_constants(iterations, device)
    neg_lr = _neg_rates(iterations, N, alpha, alpha_decay, device)

    p = torch.cat([quaternions.detach(), translations.detach()], 1).to(
        torch.float32)
    state = torch.cat([p[None], torch.zeros((2, N, 7), device=device)])
    iterates = torch.empty((iterations, N, 7), device=device)
    losses = torch.empty((iterations,), device=device)
    n_passed = stopped = n_frozen = None
    with torch.enable_grad():
        for i in range(iterations):
            p = state[0]
            iterates[i] = p
            leaf = p.detach().requires_grad_(True)
            q, t = leaf.split([4, 3], dim=1)
            loss = icc_loss(
                q, t, points, sdf, point_mask, pitch, origin, grid_target,
                grid_nontarget_empty, obj_mask, voxel_dim=voxel_dim,
                threshold=threshold, sdf_offset=sdf_offset,
                cross_mode=cross_mode,
            )
            (g,) = torch.autograd.grad(loss, leaf)
            losses[i] = loss.detach()

            # once stopped the step is discarded, so step i's bias
            # correction and rate serve whether or not the count has frozen
            new = _adam_step(state, g, decay, one_minus_decay, bias[i],
                             neg_lr[i])
            if stopped is None:
                state = new
            else:
                # frozen once stopped: parameters and moments alike
                state = torch.where(stopped, state, new)
                n_frozen = (stopped.to(torch.int32) if n_frozen is None
                            else n_frozen + stopped)

            if early_stop and i >= _WINDOW:
                window = losses[i - _WINDOW:i + 1]
                passed = (window[1:] - window[:-1]).abs().amax() < _PLATEAU
                n_passed = (passed.to(torch.int32) if n_passed is None else
                            torch.where(passed, n_passed + 1, 0))
                if i >= _WINDOW + _PASSES - 1:
                    stop_now = n_passed >= _PASSES
                    stopped = (stop_now if stopped is None
                               else stopped | stop_now)
    # the best iterate: the first of least loss, as JAX's `loss < best`
    # picks it (a NaN loss never counts)
    best = torch.where(torch.isnan(losses), math.inf, losses).argmin()
    best_p = iterates.index_select(0, best.view(1))[0]
    n_iter = torch.full((), iterations, dtype=torch.int32, device=device)
    if n_frozen is not None:
        n_iter = n_iter - n_frozen
    return best_p[:, :4], best_p[:, 4:], losses, n_iter


class IterativeCollisionCheck:
    """Host-side wrapper: pads per-object lists into the refiner's arrays.

    With ``pad_objects`` (the default) the object axis is padded to a power
    of two, and padded slots are masked out of the loss; without it the
    arrays hold the objects alone. Objects with more than ``max_points``
    points keep a random subset (seeded by the object's slot).
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
        pad_objects: bool = True,
        device="cuda",
    ):
        N = len(transforms)
        Np = 1 << (N - 1).bit_length() if pad_objects and N > 0 else N
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
        # every array goes to the device here, so that refine_async
        # uploads nothing (a blocking upload would wait for queued work)
        self._qt = (torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev))
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
        self._pending = None

    def refine_async(self, iterations: int = 30, alpha: float = 0.01,
                     early_stop: bool = True, alpha_decay: bool = False):
        """Enqueue the refinement on the device and return without reading
        anything back; :meth:`resolve` reads the result. The serving
        pipeline overlaps the refine of frame k with the host work of frame
        k+1 this way, as the reference's separate refinement node does."""
        self._pending = refine_collision(
            *self._qt, **self._arrays, **self._kw, iterations=iterations,
            alpha=alpha, early_stop=early_stop, alpha_decay=alpha_decay,
        )

    def resolve(self):
        """Read back the pending :meth:`refine_async` in one device-to-host
        copy; returns ``(transforms (N, 4, 4), losses, n_iter)``."""
        q, t, losses, n_iter = self._pending
        self._pending = None
        self._qt = (q, t)
        flat = torch.cat([q.reshape(-1), t.reshape(-1), losses,
                          n_iter.to(torch.float32)[None]]).cpu().numpy()
        nq, nt = q.numel(), t.numel()
        self._q = flat[:nq].reshape(q.shape)
        self._t = flat[nq:nq + nt].reshape(t.shape)
        return self.transforms, flat[nq + nt:-1], int(flat[-1])

    def refine(self, iterations: int = 30, alpha: float = 0.01,
               early_stop: bool = True, alpha_decay: bool = False):
        """Refine; returns ``(transforms (N, 4, 4), losses, n_iter)``."""
        self.refine_async(iterations=iterations, alpha=alpha,
                          early_stop=early_stop, alpha_decay=alpha_decay)
        return self.resolve()

    def loss_components(self, transforms=None):
        """The objective at the given (default: the current) poses, without
        refining: ``(loss, penalty_i, reward_i)``, the per-object parts of
        the real objects. uint8 grids are dequantized as ``/ 255``."""
        q, t = self._q, self._t
        if transforms is not None:
            q, t = q.copy(), t.copy()
            for i, T in enumerate(transforms[: self._n]):
                q[i] = quaternion_from_matrix(T)
                t[i] = translation_from_matrix(T)
        a = dict(self._arrays)
        for name in ("grid_target", "grid_nontarget_empty"):
            if a[name].dtype == torch.uint8:
                a[name] = a[name].to(torch.float32) / 255.0
        with torch.no_grad():
            loss, (pen, rew) = icc_loss(
                torch.from_numpy(q).to(self._device),
                torch.from_numpy(t).to(self._device), **a,
                **self._kw, return_parts=True)
        out = torch.cat([loss[None], pen, rew]).cpu().numpy()
        Np, n = pen.shape[0], self._n
        return (float(out[0]), out[1:1 + n].astype(np.float32),
                out[1 + Np:1 + Np + n].astype(np.float32))

    @property
    def transforms(self):
        out = []
        for q, t in zip(self._q[: self._n], self._t[: self._n]):
            T = quaternion_matrix_np(q)
            T[:3, 3] = t
            out.append(T)
        return np.stack(out)
