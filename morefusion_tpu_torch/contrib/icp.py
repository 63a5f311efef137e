"""Point-cloud registration: point-to-point ICP and gradient ICP.

Port of ``morefusion_tpu/contrib/icp.py``. Each ICP iteration moves the
source, finds every moved point's nearest target point and that point's
squared distance in one launch of the knn kernel (``ops/knn.py``, on the
CPU its plain version), gates the pairs at ``max_correspondence_distance``,
and aligns them with a weighted Kabsch step (Horn's quaternion by power
iteration, plain PyTorch on the tensors' device, as the JAX package computes
it outside any Pallas kernel).

The JAX package searches with ``functions/knn.py::pairwise_sq_dist``, the
float32 expansion ``|a|^2 + |b|^2 - 2 a.b``; the port searches with the
exact sum of squares, so at near-ties, at the gate's edge and in the RMSE
that stops the gated loop the two may differ by float32 rounding.

Each iteration is about two hundred small launches, and the gated loop reads
its RMSE to the host once an iteration: at a few hundred points the host's
work, not the card's, sets the time of an iteration.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..functions.transforms import compose_transform
from ..functions.transforms import quaternion_matrix
from ..functions.transforms import transform_points
from ..functions.transforms import transformation_matrix
from ..geometry import voxel_down_sample
from ..ops import knn as _knn_ops

_POWER_STEPS = 30


def _masked_kabsch(src, dst, weights):
    """Rigid ``(R, t)`` minimizing ``sum w_i |R src_i + t - dst_i|^2``.

    Horn's method: the quaternion is the dominant eigenvector of the 4x4
    form of the weighted correlation, found by 30 steps of power iteration
    shifted so that the largest eigenvalue dominates. Always a proper
    rotation, also where the best orthogonal fit is a reflection. All-zero
    weights give the identity.
    """
    w = weights / torch.sum(weights).clamp_min(1e-12)
    mu_s = torch.sum(src * w[:, None], dim=0)
    mu_d = torch.sum(dst * w[:, None], dim=0)
    S = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)  # (3, 3)
    # Horn's symmetric form: [[tr S, d^T], [d, S + S^T - (tr S) I]] with
    # d = (S12 - S21, S20 - S02, S01 - S10)
    tr = torch.trace(S)
    A = S - S.T
    d = torch.stack([A[1, 2], A[2, 0], A[0, 1]])
    lower = S + S.T - torch.diag_embed(tr.expand(3))
    N = torch.cat([torch.cat([tr[None], d])[None],
                   torch.cat([d[:, None], lower], dim=1)])
    shift = 2.0 * torch.sqrt(torch.sum(S * S)) + 1e-12
    M = N + torch.diag_embed(shift.expand(4))
    # the first step from the identity quaternion (1, 0, 0, 0) is M's first
    # column
    q = M[:, 0]
    for step in range(_POWER_STEPS):
        if step:
            q = M @ q
        q = q / torch.linalg.vector_norm(q).clamp_min(1e-20)
    R = quaternion_matrix(q)[:3, :3]
    t = mu_d - R @ mu_s
    return R, t


def _icp_step(source, target, T, thresh_sq):
    """One iteration: ``(delta @ T, winners' d2, gate weights)``."""
    moved = source @ T[:3, :3].T + T[:3, 3]  # (N, 3)
    idx, d2 = _knn_ops.nn_indices(target[None], moved[None], return_d2=True)
    idx, d2 = idx[0].long(), d2[0]
    w = (d2 < thresh_sq).to(moved.dtype)
    R, t = _masked_kabsch(moved, target[idx], w)
    return compose_transform(R, t) @ T, d2, w


def _prepare(source, target, T_init):
    return (source.to(torch.float32).contiguous(),
            target.to(torch.float32).contiguous(),
            T_init.to(device=source.device, dtype=torch.float32))


def icp_point_to_point(
    source: torch.Tensor,
    target: torch.Tensor,
    T_init: torch.Tensor,
    max_correspondence_distance: float = 0.02,
    iterations: int = 100,
) -> torch.Tensor:
    """Align ``source (N, 3)`` onto ``target (M, 3)`` in a fixed number of
    iterations; returns ``T (4, 4)`` with ``target ~= T @ source``, starting
    from ``T_init``, the source-to-target transform."""
    source, target, T = _prepare(source, target, T_init)
    thresh_sq = max_correspondence_distance**2
    for _ in range(iterations):
        T, _, _ = _icp_step(source, target, T, thresh_sq)
    return T


def icp_point_to_point_gated(
    source: torch.Tensor,
    target: torch.Tensor,
    T_init: torch.Tensor,
    max_correspondence_distance: float = 0.02,
    max_iterations: int = 100,
    rel_tol: float = 5e-3,
) -> Tuple[torch.Tensor, int]:
    """:func:`icp_point_to_point` that stops when the inlier RMSE stops
    improving: after an iteration whose RMSE is below 1e-6, or within
    ``rel_tol * min(rmse, 1e6) + 2e-7`` of the RMSE of either of the two
    iterations before it (point-to-point ICP often ends in a period-2 cycle
    of correspondences, where the RMSE repeats every other iteration).

    The RMSE is read to the host once an iteration; the rule is evaluated
    there in float32, as the JAX loop evaluates it on the device. Returns
    ``(T (4, 4), n_iterations)``.
    """
    source, target, T = _prepare(source, target, T_init)
    thresh_sq = max_correspondence_distance**2
    f32 = np.float32
    prev1 = prev2 = f32(np.inf)
    n = 0
    while n < max_iterations:
        T, d2, w = _icp_step(source, target, T, thresh_sq)
        rmse = f32(torch.sqrt(torch.sum(d2 * w)
                              / torch.sum(w).clamp_min(1.0)).item())
        n += 1
        thresh = f32(rel_tol) * min(rmse, f32(1e6)) + f32(2e-7)
        if (rmse < f32(1e-6) or abs(prev1 - rmse) < thresh
                or abs(prev2 - rmse) < thresh):
            break
        prev1, prev2 = rmse, prev1
    return T, n


class ICPRegistration:
    """Refine a CAD model's pose against its observed depth points.

    As the JAX package's wrapper: both clouds are voxel down-sampled, the
    depth cloud is aligned onto the CAD cloud from the inverted initial pose
    (every observed point has a true match on the model, while the model's
    unseen back would drag a fit the other way), and the result is inverted
    in float64. The JAX wrapper pads both clouds to a power-of-two bucket
    with far sentinels so that XLA compiles one program a bucket; the
    sentinels never pass the gate, so the port, which compiles nothing,
    does not pad and gives the same poses.
    """

    def __init__(self, pcd_depth, pcd_cad, transform_init=None,
                 device="cuda"):
        self._pcd_depth = np.asarray(pcd_depth)
        self._pcd_cad = np.asarray(pcd_cad)
        self._transform = (
            np.eye(4) if transform_init is None else np.asarray(transform_init)
        )
        self._device = torch.device(device)
        self.last_n_iterations = None

    def _prepared(self, voxel_size):
        return tuple(
            torch.from_numpy(
                voxel_down_sample(pcd, voxel_size).astype(np.float32)
            ).to(self._device)
            for pcd in (self._pcd_depth, self._pcd_cad))

    def _depth2cad_init(self):
        return torch.from_numpy(
            np.linalg.inv(self._transform).astype(np.float32)
        ).to(self._device)

    def _set_from_depth2cad(self, T_depth2cad):
        self._transform = np.linalg.inv(
            T_depth2cad.cpu().numpy().astype(np.float64))

    def register(self, iteration=None, voxel_size=None) -> np.ndarray:
        """Gated ICP (at most ``iteration`` iterations, default 100) at
        ``voxel_size`` (default 0.01 m; the gate is twice it). Returns the
        refined ``T_cad2cam`` and sets ``last_n_iterations``."""
        iteration = 100 if iteration is None else iteration
        voxel_size = 0.01 if voxel_size is None else voxel_size
        depth, cad = self._prepared(voxel_size)
        T_depth2cad, self.last_n_iterations = icp_point_to_point_gated(
            depth, cad, self._depth2cad_init(),
            max_correspondence_distance=2 * voxel_size,
            max_iterations=int(iteration),
        )
        self._set_from_depth2cad(T_depth2cad)
        return self._transform

    def register_iterative(self, iteration=None, voxel_size=None):
        """Yield the initial pose, then the pose after each of ``iteration``
        single ICP iterations (for playback)."""
        iteration = 100 if iteration is None else iteration
        voxel_size = 0.01 if voxel_size is None else voxel_size
        depth, cad = self._prepared(voxel_size)
        yield self._transform
        for _ in range(iteration):
            self._set_from_depth2cad(icp_point_to_point(
                depth, cad, self._depth2cad_init(),
                max_correspondence_distance=2 * voxel_size, iterations=1))
            yield self._transform


def gradient_icp(
    source: torch.Tensor,
    target: torch.Tensor,
    quaternion_init: torch.Tensor,
    translation_init: torch.Tensor,
    learning_rate: float = 0.01,
    gate: float = 0.02,
    iterations: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam on (quaternion, translation) with a gated correspondence loss.

    Each step matches every ``target`` point to its nearest moved ``source``
    point (the search sees the moved source without gradient; the gather is
    differentiable), keeps the pairs whose squared distance is below
    ``gate`` and takes the sum of their squared distances as the loss.
    Adam as ``optax.adam`` (betas 0.9 and 0.999, eps 1e-8). Returns
    ``(quaternion, translation, losses (iterations,))``, each loss taken
    before its step's update.
    """
    source = source.to(torch.float32)
    target = target.to(torch.float32).contiguous()
    q = quaternion_init.detach().to(torch.float32).clone().requires_grad_()
    t = translation_init.detach().to(torch.float32).clone().requires_grad_()
    opt = torch.optim.Adam([q, t], lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(iterations):
        moved = transform_points(source, transformation_matrix(q, t))
        corr = _knn_ops.nn_indices(moved.detach()[None].contiguous(),
                                   target[None])[0].long()
        sq = torch.sum((moved[corr] - target) ** 2, dim=1)
        loss = torch.sum(torch.where(sq.detach() < gate, sq, 0.0))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return q.detach(), t.detach(), torch.stack(losses)
