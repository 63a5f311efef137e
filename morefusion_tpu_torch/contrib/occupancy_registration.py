"""Occupancy-grid pose registration of one object.

Port of ``morefusion_tpu/contrib/occupancy_registration.py``: a quaternion
and a translation optimised by Adam (``optax.adam``; the translation's rate
is ``0.1 * alpha``) against the soft occupancy grid of the moved CAD
points, which is rewarded for overlapping the target's occupied grid and
penalised for overlapping its free or unknown space. JAX's ``lax.scan``
becomes a loop on the device: the loss, gradient and Adam step of every
iteration are queued without a read to the host, and the losses (and the
trajectory) are read once at the end. Each iteration launches the
min-distance kernel once (``functions/occupancy.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..functions.occupancy import occupancy_grid_3d
from ..functions.transforms import transform_points, transformation_matrix
from ..geometry.transform import (
    quaternion_from_matrix,
    quaternion_matrix_np,
    translation_from_matrix,
)
from .collision_refine import _adam_constants, _adam_step, _neg_rates


def occupancy_registration_loss(quaternion, translation, points_source,
                                grid_target, *, pitch, origin, threshold):
    """``penalty - reward`` of the moved points' soft occupancy grid.

    ``grid_target (2 or 3, X, Y, Z)`` holds the occupied grid, then the
    empty one (and the unknown one; free space is their maximum)."""
    T = transformation_matrix(quaternion, translation)
    moved = transform_points(points_source, T)
    grid_source = occupancy_grid_3d(moved, pitch=pitch, origin=origin,
                                    dims=tuple(grid_target.shape[1:]),
                                    threshold=threshold)
    occupied = grid_target[0]
    reward = torch.sum(occupied * grid_source) / torch.sum(
        occupied).clamp_min(1e-16)
    if grid_target.shape[0] == 3:
        unoccupied = torch.maximum(grid_target[1], grid_target[2])
    else:
        unoccupied = grid_target[1]
    penalty = torch.sum(unoccupied * grid_source) / torch.sum(
        grid_source).clamp_min(1e-16)
    return penalty - reward


def register_occupancy(points_source, grid_target, quaternion_init,
                       translation_init, *, pitch, origin, threshold=2.0,
                       iterations: int = 100, alpha: float = 0.1,
                       trajectory: bool = False):
    """``iterations`` Adam steps; returns ``(quaternion, translation,
    losses)`` as tensors on the inputs' device.

    With ``trajectory=True`` the quaternion and translation are the
    ``(iterations, 4)`` / ``(iterations, 3)`` parameters after each step of
    the one optimisation. ``losses[k]`` is the loss before step ``k``."""
    device = points_source.device
    decay, one_minus_decay, bias = _adam_constants(iterations, device)
    neg_lr = _neg_rates(iterations, 1, alpha, False, device)
    p = torch.cat([torch.as_tensor(quaternion_init, device=device),
                   torch.as_tensor(translation_init, device=device)]).to(
        torch.float32)[None]
    state = torch.cat([p[None], torch.zeros((2, 1, 7), device=device)])
    losses = torch.empty((iterations,), device=device)
    traj = (torch.empty((iterations, 7), device=device) if trajectory
            else None)
    with torch.enable_grad():
        for i in range(iterations):
            leaf = state[0].detach().requires_grad_(True)
            q, t = leaf[0].split([4, 3])
            loss = occupancy_registration_loss(
                q, t, points_source, grid_target, pitch=pitch,
                origin=origin, threshold=threshold)
            (g,) = torch.autograd.grad(loss, leaf)
            losses[i] = loss.detach()
            state = _adam_step(state, g, decay, one_minus_decay, bias[i],
                               neg_lr[i])
            if trajectory:
                traj[i] = state[0, 0]
    if trajectory:
        return traj[:, :4], traj[:, 4:], losses
    return state[0, 0, :4], state[0, 0, 4:], losses


class OccupancyRegistration:
    """Host wrapper of :func:`register_occupancy`: NumPy in and out, the
    arrays on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, points_source, grid_target, *, pitch, origin,
                 threshold, transform_init, alpha=0.1, device="cuda"):
        self._device = torch.device(device)
        self._points = torch.from_numpy(
            np.asarray(points_source, np.float32)).to(self._device)
        self._grid = torch.from_numpy(
            np.asarray(grid_target, np.float32)).to(self._device)
        self._pitch = float(pitch)
        self._origin = torch.from_numpy(
            np.asarray(origin, np.float32)).to(self._device)
        self._threshold = float(threshold)
        self._alpha = float(alpha)
        self._q = quaternion_from_matrix(transform_init).astype(np.float32)
        self._t = translation_from_matrix(transform_init).astype(np.float32)

    @property
    def _transform(self):
        T = quaternion_matrix_np(self._q)
        T[:3, 3] = self._t
        return T

    def _run(self, iterations, trajectory):
        q, t, _ = register_occupancy(
            self._points, self._grid, torch.from_numpy(self._q),
            torch.from_numpy(self._t), pitch=self._pitch,
            origin=self._origin, threshold=self._threshold,
            iterations=iterations, alpha=self._alpha, trajectory=trajectory)
        return torch.cat([q, t], -1).cpu().numpy()

    def register(self, iteration=None):
        """Run ``iteration`` steps (default 100); returns the transform."""
        iteration = 100 if iteration is None else int(iteration)
        qt = self._run(iteration, False)
        self._q, self._t = qt[:4], qt[4:]
        return self._transform

    def register_iterative(self, iteration=None):
        """Yield the transform before the first step and after each of
        ``iteration`` steps (default 100) of one continuous optimisation,
        read back once."""
        iteration = 100 if iteration is None else int(iteration)
        yield self._transform
        qt = self._run(iteration, True)
        for k in range(iteration):
            self._q, self._t = qt[k, :4], qt[k, 4:]
            yield self._transform
