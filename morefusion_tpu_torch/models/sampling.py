"""Fixed-shape masked point sampling and the voxel-grid origin.

Port of ``morefusion_tpu/models/sampling.py``. Random bits come from an
explicit ``torch.Generator``; they differ from ``jax.random``'s, so tests
that compare with the JAX package pass the indices in.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_mask_indices(mask: torch.Tensor, n_point: int,
                        generator: Optional[torch.Generator] = None):
    """``(B, n_point)`` int64 flat pixel indices of valid pixels of
    ``mask (B, H, W)``: a uniform subset without replacement, cycled
    through the valid picks when fewer than ``n_point`` are valid (all
    zero for an empty mask)."""
    B, H, W = mask.shape
    flat = mask.reshape(B, H * W)
    scores = torch.rand((B, H * W), generator=generator,
                        device=mask.device)
    scores = torch.where(flat, scores, float("-inf"))
    idx = torch.topk(scores, n_point, dim=1).indices  # valid first
    n_valid = flat.sum(dim=1, keepdim=True).clamp_min(1)
    slot = torch.arange(n_point, device=mask.device)[None, :]
    wrapped = torch.where(slot < n_valid, slot, slot % n_valid)
    return torch.gather(idx, 1, wrapped)


def gather_pixels(image: torch.Tensor, indices: torch.Tensor):
    """``image (B, H, W, C)`` at flat ``indices (B, P)`` -> ``(B, P, C)``."""
    B, H, W, C = image.shape
    flat = image.reshape(B, H * W, C)
    return torch.gather(flat, 1, indices[..., None].expand(-1, -1, C))


def masked_median(values: torch.Tensor, mask: torch.Tensor):
    """Median of ``values (B, N, C)`` over ``mask (B, N)`` -> ``(B, C)``.

    Like ``jnp.nanmedian``, an even count gives the mean of the two middle
    values (``torch.nanmedian`` would give the lower one); an empty mask
    gives NaN.
    """
    x = torch.where(mask[..., None], values, float("nan"))
    x = torch.sort(x, dim=1).values  # NaN sorts last
    N = x.shape[1]
    n = mask.sum(dim=1).to(values.dtype)[:, None, None]  # (B, 1, 1)
    q = 0.5 * (n - 1)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    lo = lo.clamp(0, N - 1).to(torch.int64).expand(-1, 1, x.shape[2])
    hi = hi.clamp(0, N - 1).to(torch.int64).expand(-1, 1, x.shape[2])
    v_lo = torch.gather(x, 1, lo)
    v_hi = torch.gather(x, 1, hi)
    out = v_lo * (1 - w_hi) + v_hi * w_hi
    return torch.where(n > 0, out, float("nan"))[:, 0]


def compute_origin(pcd, mask, pitch, voxel_dim: int):
    """Grid origin that puts the masked median point at the grid centre:
    ``median - pitch * (voxel_dim / 2 - 0.5)``."""
    B = pcd.shape[0]
    center = masked_median(pcd.reshape(B, -1, 3), mask.reshape(B, -1))
    return center - pitch[:, None] * (voxel_dim / 2.0 - 0.5)
