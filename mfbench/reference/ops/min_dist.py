"""Per-voxel nearest valid point, in plain PyTorch: a frozen copy of
``morefusion_tpu_torch/ops/min_dist.py::min_dist_voxels_plain`` (same
contract).
"""

from __future__ import annotations

import torch



def _check_args(ip, valid, payload, dims):
    if ip.dtype != torch.float32 or ip.dim() != 3 or ip.shape[-1] != 3:
        raise ValueError(f"ip must be float32 (B, P, 3), got {ip.dtype} "
                         f"{tuple(ip.shape)}")
    B, P, _ = ip.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (B, P):
        raise ValueError(f"valid must be bool {(B, P)}, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if payload.dtype != torch.int32 or tuple(payload.shape) != (B, P):
        raise ValueError(f"payload must be int32 {(B, P)}, got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    if len(dims) != 3 or min(dims) <= 0:
        raise ValueError(f"dims must be three positive ints, got {dims}")
    devices = {ip.device, valid.device, payload.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")


def voxel_centers(dims, device, dtype=torch.float32):
    """``(V, 3)`` integer voxel centres in the flat order of the grid."""
    X, Y, Z = dims
    ii, jj, kk = torch.meshgrid(
        torch.arange(X, device=device, dtype=dtype),
        torch.arange(Y, device=device, dtype=dtype),
        torch.arange(Z, device=device, dtype=dtype),
        indexing="ij",
    )
    return torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3)


def min_dist_voxels_plain(ip, valid, payload, dims, chunk: int = 64):
    """The kernel's arithmetic in PyTorch, ``chunk`` points at a time."""
    _check_args(ip, valid, payload, dims)
    B, P, _ = ip.shape
    c = voxel_centers(dims, ip.device)  # (V, 3)
    V = c.shape[0]
    ok = valid & ~torch.isnan(ip).any(dim=-1)
    pts = torch.where(ok[..., None], ip, torch.full_like(ip, float("inf")))
    best = torch.full((B, V), float("inf"), device=ip.device)
    arg = torch.full((B, V), -1, dtype=torch.int32, device=ip.device)
    pay = torch.zeros((B, V), dtype=torch.int32, device=ip.device)
    for base in range(0, P, chunk):
        p = pts[:, base:base + chunk]  # (B, n, 3)
        dx = c[None, :, None, 0] - p[:, None, :, 0]  # (B, V, n)
        dy = c[None, :, None, 1] - p[:, None, :, 1]
        dz = c[None, :, None, 2] - p[:, None, :, 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        cmin, carg = torch.min(d2, dim=2)  # first index wins a tie
        better = cmin < best
        best = torch.where(better, cmin, best)
        arg = torch.where(better, (carg + base).to(torch.int32), arg)
        cpay = torch.gather(payload[:, base:base + chunk], 1, carg)
        pay = torch.where(better, cpay, pay)
    return best, arg, pay


min_dist_voxels = min_dist_voxels_plain
