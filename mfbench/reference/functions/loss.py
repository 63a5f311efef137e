"""Pose losses: ADD / ADD-S average distance and the confidence weighting.

Port of ``morefusion_tpu/functions/loss.py``, batched over a leading lane
axis where the JAX package uses ``vmap``. ADD-S matches each predicted
point to its nearest true point (``knn.nn``, indices without gradient).
"""

from __future__ import annotations

import torch

from .knn import nn
from .transforms import transform_points


def average_distance(points, transform_true, transforms_pred,
                     symmetric: bool = False):
    """ADD (or ADD-S) between one true pose and ``M`` predicted poses per lane.

    ``points (B, N, 3)`` CAD points, ``transform_true (B, 4, 4)``,
    ``transforms_pred (B, M, 4, 4)`` -> ``(B, M)`` mean distances.
    """
    B, N, _ = points.shape
    M = transforms_pred.shape[1]
    points_true = transform_points(points, transform_true)  # (B, N, 3)
    R = transforms_pred[..., :3, :3]
    t = transforms_pred[..., :3, 3]
    points_pred = (torch.einsum("bmij,bnj->bmni", R, points)
                   + t[:, :, None, :])  # (B, M, N, 3)
    if symmetric:
        idx = nn(points_true, points_pred.reshape(B, M * N, 3))
        matched = torch.gather(
            points_true, 1, idx.long()[..., None].expand(-1, -1, 3)
        ).reshape(B, M, N, 3)
    else:
        matched = points_true[:, None]
    d = torch.sqrt(torch.sum((matched - points_pred) ** 2, dim=-1) + 1e-12)
    return d.mean(dim=-1)


def average_distance_both(points, transform_true, transforms_pred):
    """``(ADD, ADD-S)``, each ``(B, M)``: both are computed so that a caller
    can select per lane without a branch."""
    add = average_distance(points, transform_true, transforms_pred, False)
    add_s = average_distance(points, transform_true, transforms_pred, True)
    return add, add_s


LAMBDA_CONFIDENCE = 0.015  # the weight of the confidence regularizer


def densefusion_confidence_loss(add, confidence):
    """Per lane ``mean(add * c - LAMBDA_CONFIDENCE * log(c))`` over
    ``(B, P)`` -> ``(B,)``.

    Entries with ``confidence <= 0`` are left out of the sum and the count.
    """
    keep = confidence > 0
    c = torch.where(keep, confidence, torch.ones_like(confidence))
    terms = add * confidence - LAMBDA_CONFIDENCE * torch.log(c)
    terms = torch.where(keep, terms, torch.zeros_like(terms))
    return terms.sum(dim=-1) / keep.sum(dim=-1).clamp_min(1)
