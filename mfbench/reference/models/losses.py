"""Batched training loss and evaluation of the pose models.

Port of ``morefusion_tpu/models/losses.py``, with the lane axis written out
where the JAX package uses ``vmap``. The caller gathers fixed-shape CAD
point sets per sample (``(B, N, 3)``). The occupancy term voxelizes the
solid CAD points under the best-confidence pose and rewards overlap with
the target grid and penalizes overlap with known non-target or empty space.
"""

from __future__ import annotations

import torch

from .. import functions as F

OCCUPANCY_THRESHOLD = 2.0  # the occupancy loss's truncation, in voxels


def _best_pose(quaternion_pred, translation_pred, confidence_pred):
    """Each lane's highest-confidence pose (the first on a tie)."""
    best = torch.argmax(confidence_pred, dim=1)  # (B,)
    bidx = torch.arange(best.shape[0], device=best.device)
    return quaternion_pred[bidx, best], translation_pred[bidx, best]


def pose_loss(
    *,
    quaternion_pred,  # (B, P, 4)
    translation_pred,  # (B, P, 3)
    confidence_pred,  # (B, P)
    quaternion_true,  # (B, 4)
    translation_true,  # (B, 3)
    cad_points,  # (B, N, 3) gathered per sample class
    symmetric,  # (B,) bool, already resolved per loss variant
):
    """DenseFusion confidence-weighted ADD(-S) loss, averaged over lanes.

    ADD and ADD-S are both computed and one is selected per lane.
    """
    T_true = F.transformation_matrix(quaternion_true, translation_true)
    T_pred = F.transformation_matrix(quaternion_pred, translation_pred)
    add, add_s = F.average_distance_both(cad_points, T_true, T_pred)
    add = torch.where(symmetric[:, None], add_s, add)  # (B, P)
    return F.densefusion_confidence_loss(add, confidence_pred).mean()


def occupancy_loss(
    *,
    quaternion_pred,  # (B, P, 4)
    translation_pred,  # (B, P, 3)
    confidence_pred,  # (B, P)
    solid_points,  # (B, M, 3) padded solid CAD points
    solid_sdf,  # (B, M) signed distance of each solid point
    solid_mask,  # (B, M) validity of the padding
    pitch,  # (B,)
    origin,  # (B, 3)
    grid_target,  # (B, V, V, V)
    grid_nontarget_empty,  # (B, V, V, V)
):
    """Collision / occupancy consistency of the best-confidence pose, on
    the grids' ``V^3`` voxels, truncated at ``OCCUPANCY_THRESHOLD``
    voxels."""
    q, t = _best_pose(quaternion_pred, translation_pred, confidence_pred)
    T = F.transformation_matrix(q, t)  # (B, 4, 4)
    moved = F.transform_points(solid_points, T)  # (B, M, 3)
    grid_u, _, _ = F.pseudo_occupancy_voxelization(
        moved,
        solid_sdf,
        pitch=pitch,
        origin=origin,
        dims=tuple(grid_target.shape[1:]),
        threshold=OCCUPANCY_THRESHOLD,
        point_mask=solid_mask,
    )  # (B, V, V, V)
    dims = (1, 2, 3)
    reward = (torch.sum(grid_u * grid_target, dim=dims)
              / (torch.sum(grid_target, dim=dims) + 1e-16))
    penalty = (torch.sum(grid_u * grid_nontarget_empty, dim=dims)
               / (torch.sum(grid_u, dim=dims) + 1e-16))
    return torch.mean(penalty - reward)


def evaluate_add(
    *,
    quaternion_pred,  # (B, P, 4)
    translation_pred,  # (B, P, 3)
    confidence_pred,  # (B, P)
    quaternion_true,  # (B, 4)
    translation_true,  # (B, 3)
    cad_points,  # (B, N, 3)
    symmetric,  # (B,) bool class-symmetry table entries
):
    """ADD, ADD-S and ADD-or-ADD-S of the best-confidence pose, each ``(B,)``."""
    q, t = _best_pose(quaternion_pred, translation_pred, confidence_pred)
    T_true = F.transformation_matrix(quaternion_true, translation_true)
    T_pred = F.transformation_matrix(q, t)
    add, add_s = F.average_distance_both(cad_points, T_true, T_pred[:, None])
    add, add_s = add[:, 0], add_s[:, 0]
    return {
        "add": add,
        "add_s": add_s,
        "add_or_add_s": torch.where(symmetric, add_s, add),
    }
