"""Per-voxel nearest valid point: the CUDA kernel and its plain version.

Replaces ``morefusion_tpu/ops/min_dist_pallas.py::_kernel``. The kernel is
``csrc/min_dist.cu`` (its header says what bounds it and how it is laid
out); :func:`min_dist_voxels_plain` is its plain version.

Contract, for points in voxel units ``ip (B, P, 3)``, ``valid (B, P)``,
``payload (B, P)`` int32 and a grid ``dims = (X, Y, Z)`` whose voxel
``v = (i * Y + j) * Z + k`` has its centre at ``(i, j, k)``:

- ``d2 (B, V)`` float32: squared distance to the nearest valid, non-NaN
  point, ``inf`` where there is none;
- ``arg (B, V)`` int32: that point's index, the lowest index on a tie,
  ``-1`` where there is none;
- ``pay (B, V)`` int32: ``payload`` of that point, ``0`` where there is
  none.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_SPLITS = _build.Kernel("mfk_min_dist_splits", [_int] * 6)
_MIN_DIST = _build.Kernel("mfk_min_dist", [
    _ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _int, _ptr, _ptr, _ptr,
    _ptr, _int, _ptr,
])

# the kernel splits the point axis in at most 65535 parts of at most 2048
_MAX_POINTS = 65535 * 2048


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


@functools.lru_cache(maxsize=64)
def _splits(B, P, X, Y, Z, device):
    """Splits of the point axis the kernel takes at these shapes on this
    card: one key (d2 bits << 32 | index) per split and voxel."""
    splits = _SPLITS.function()(B, P, X, Y, Z, device)
    if splits < 1:
        raise RuntimeError(f"min_dist: cannot query CUDA device {device}")
    return splits


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


def min_dist_voxels(ip, valid, payload, dims):
    """Each voxel's nearest valid point, as the contract above says."""
    _check_args(ip, valid, payload, dims)
    if not _build.on_card(ip, "min_dist"):
        return min_dist_voxels_plain(ip, valid, payload, dims)
    for name, t in (("ip", ip), ("valid", valid), ("payload", payload)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, P, _ = ip.shape
    X, Y, Z = (int(d) for d in dims)
    V = X * Y * Z
    if B > 65535:
        raise ValueError(f"at most 65535 lanes, got {B}")
    if V >= 2**31 or P > _MAX_POINTS:
        raise ValueError(f"at most 2**31 - 1 voxels and {_MAX_POINTS} points "
                         f"a lane, got {V} and {P}")
    d2 = torch.empty((B, V), dtype=torch.float32, device=ip.device)
    arg = torch.empty((B, V), dtype=torch.int32, device=ip.device)
    pay = torch.empty((B, V), dtype=torch.int32, device=ip.device)
    splits = _splits(B, P, X, Y, Z, ip.device.index)
    keys = torch.empty((splits, B, V), dtype=torch.int64, device=ip.device)
    _MIN_DIST(ip.device, ip.data_ptr(), valid.data_ptr(), payload.data_ptr(),
              B, P, X, Y, Z, splits, keys.data_ptr(),
              d2.data_ptr(), arg.data_ptr(), pay.data_ptr())
    min_dist_voxels.launches += 1
    return d2, arg, pay


min_dist_voxels.launches = 0
