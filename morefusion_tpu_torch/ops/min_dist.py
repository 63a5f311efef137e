"""Per-voxel nearest valid point: the CUDA kernel and its plain version.

Replaces ``morefusion_tpu/ops/min_dist_pallas.py::_kernel``. The kernel is
``csrc/min_dist.cu`` (its header says what bounds it and how it is laid
out); :func:`min_dist_voxels` launches it for CUDA tensors and runs
:func:`min_dist_voxels_plain` for CPU tensors, and for nothing else.

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

import torch

from . import _build


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


def min_dist_voxels(ip, valid, payload, dims):
    """Launch the CUDA kernel for CUDA tensors; the plain version on CPU.

    Outputs are allocated here and the kernel runs on the current stream
    without synchronising. Counts its launches in ``min_dist_voxels.launches``.
    """
    _check_args(ip, valid, payload, dims)
    if ip.device.type == "cpu":
        return min_dist_voxels_plain(ip, valid, payload, dims)
    if ip.device.type != "cuda":
        raise ValueError(f"no min_dist kernel for device {ip.device}")
    for name, t in (("ip", ip), ("valid", valid), ("payload", payload)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, P, _ = ip.shape
    X, Y, Z = (int(d) for d in dims)
    V = X * Y * Z
    if B > 65535:
        raise ValueError(f"at most 65535 lanes, got {B}")
    d2 = torch.empty((B, V), dtype=torch.float32, device=ip.device)
    arg = torch.empty((B, V), dtype=torch.int32, device=ip.device)
    pay = torch.empty((B, V), dtype=torch.int32, device=ip.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(ip.device).cuda_stream
    err = lib.mfk_min_dist(
        ip.data_ptr(), valid.data_ptr(), payload.data_ptr(),
        B, P, X, Y, Z,
        d2.data_ptr(), arg.data_ptr(), pay.data_ptr(),
        ip.device.index, stream,
    )
    _build.check(lib, err, "min_dist launch")
    min_dist_voxels.launches += 1
    return d2, arg, pay


min_dist_voxels.launches = 0
