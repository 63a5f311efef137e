"""Nearest reference point per query, in plain PyTorch: a frozen copy of
``morefusion_tpu_torch/ops/knn.py::nn_indices_plain`` (same contract).
"""

from __future__ import annotations

import torch

# elements of one (B, chunk, R) distance block of the plain version: at the
# training shape a whole (B, Q, R) block would take 16 GB
_PLAIN_BLOCK = 1 << 25


def _check_args(ref, query):
    for name, t in (("ref", ref), ("query", query)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be float32 (B, n, 3), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if ref.shape[0] != query.shape[0]:
        raise ValueError(f"ref has {ref.shape[0]} lanes, query "
                         f"{query.shape[0]}")
    if ref.shape[1] < 1:
        raise ValueError("ref must hold at least one point")
    if ref.device != query.device:
        raise ValueError(f"inputs lie on different devices: {ref.device}, "
                         f"{query.device}")


def nn_indices_plain(ref, query, return_d2=False):
    """The kernel's arithmetic in PyTorch, a block of queries at a time."""
    _check_args(ref, query)
    B, R, _ = ref.shape
    Q = query.shape[1]
    chunk = max(1, _PLAIN_BLOCK // (B * R))
    out = torch.empty((B, Q), dtype=torch.int32, device=query.device)
    best = (torch.empty((B, Q), dtype=torch.float32, device=query.device)
            if return_d2 else None)
    r = ref[:, None, :, :]  # (B, 1, R, 3)
    for base in range(0, Q, chunk):
        q = query[:, base:base + chunk, None, :]  # (B, n, 1, 3)
        dx = q[..., 0] - r[..., 0]  # (B, n, R)
        dy = q[..., 1] - r[..., 1]
        dz = q[..., 2] - r[..., 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        # NaN counts as +inf, and +inf stays +inf (nan_to_num's default
        # would turn it into the largest float, below a NaN's +inf)
        d2 = torch.nan_to_num(d2, nan=float("inf"), posinf=float("inf"))
        # first index wins a tie; an all-inf row gives 0
        arg = torch.argmin(d2, dim=2, keepdim=True)
        out[:, base:base + chunk] = arg[..., 0].to(torch.int32)
        if return_d2:
            best[:, base:base + chunk] = torch.gather(d2, 2, arg)[..., 0]
    return (out, best) if return_d2 else out


nn_indices = nn_indices_plain
