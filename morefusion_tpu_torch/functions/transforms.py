"""Differentiable SE(3) / quaternion transforms.

Port of ``morefusion_tpu/functions/transforms.py``. Quaternions are
``(w, x, y, z)`` and are normalized inside, so gradients flow through the
normalization.
"""

from __future__ import annotations

import torch


def quaternion_matrix(quaternion: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` quaternions -> ``(..., 4, 4)`` rotations, no translation."""
    q = quaternion
    squeeze = q.dim() == 1
    if squeeze:
        q = q[None]
    batch_shape = q.shape[:-1]
    q = q.reshape(-1, 4)
    q = q * torch.sqrt(2.0 / torch.sum(q * q, dim=1, keepdim=True))
    w, x, y, z = q.unbind(dim=1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one, zero = torch.ones_like(w), torch.zeros_like(w)
    rows = [
        [1 - yy - zz, xy - wz, xz + wy, zero],
        [xy + wz, 1 - xx - zz, yz - wx, zero],
        [xz - wy, yz + wx, 1 - xx - yy, zero],
        [zero, zero, zero, one],
    ]
    T = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    T = T.reshape(*batch_shape, 4, 4)
    return T[0] if squeeze else T


def compose_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` rotations and ``(..., 3)`` translations -> ``(..., 4, 4)``."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device)
    bottom = bottom.expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def transformation_matrix(quaternion, translation) -> torch.Tensor:
    """``(quaternion, translation)`` -> ``(..., 4, 4)`` transforms."""
    T = quaternion_matrix(quaternion)
    return compose_transform(T[..., :3, :3], translation)


def transform_points(points, transform) -> torch.Tensor:
    """Apply transforms to points.

    ``points (N, 3)`` with ``transform (4, 4)`` -> ``(N, 3)``; with
    ``(M, 4, 4)`` -> ``(M, N, 3)``; batched ``points (M, N, 3)`` with
    ``(M, 4, 4)`` -> ``(M, N, 3)``, each set by its own transform.
    """
    squeeze = transform.dim() == 2
    if squeeze:
        transform = transform[None]
    R = transform[..., :3, :3]
    t = transform[..., :3, 3]
    if points.dim() == 3:
        out = torch.einsum("mij,mnj->mni", R, points)
    else:
        out = torch.einsum("mij,nj->mni", R, points)
    out = out + t[:, None, :]
    return out[0] if squeeze else out
