"""Nearest reference point per query: the CUDA kernel and its plain version.

Replaces ``morefusion_tpu/ops/knn_pallas.py::_kernel`` (``nn_pallas``, which
has no caller in the JAX package: its ADD-S runs the XLA expansion of
``functions/knn.py::nn`` and its ICP ``pairwise_sq_dist``, whose places this
kernel takes in the port's train step and in ``contrib/icp.py``). The kernel
is
``csrc/knn.cu`` (its header says what bounds it and how it is laid out);
:func:`nn_indices_plain` is its plain version.

Contract, for ``ref (B, R, 3)`` and ``query (B, Q, 3)`` float32, ``R >= 1``:
``(B, Q)`` int32, the index into ``ref[b]`` of the nearest reference point
of ``query[b, q]`` by ``dx*dx + dy*dy + dz*dz`` in float32 (each operation
rounded, summed in that order), the lowest index on a tie. A NaN distance
counts as ``+inf``; a query with no finite distance gets 0. With
``return_d2=True`` also ``(B, Q)`` float32, the winner's squared distance by
that same arithmetic (``+inf`` where no distance is finite): ICP's gate and
RMSE read it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_KNN = _build.Kernel("mfk_knn", [_ptr, _ptr, _int, _int, _int, _ptr, _ptr,
                                 _int, _ptr])

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


def nn_indices(ref, query, return_d2=False):
    """Each query's nearest reference point, as the contract above says."""
    _check_args(ref, query)
    if not _build.on_card(query, "knn"):
        return nn_indices_plain(ref, query, return_d2)
    for name, t in (("ref", ref), ("query", query)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, R, _ = ref.shape
    Q = query.shape[1]
    if B > 65535:
        raise ValueError(f"at most 65535 lanes, got {B}")
    if Q > 2**31 - 256:
        raise ValueError(f"at most 2**31 - 256 queries a lane, got {Q}")
    out = torch.empty((B, Q), dtype=torch.int32, device=query.device)
    d2 = (torch.empty((B, Q), dtype=torch.float32, device=query.device)
          if return_d2 else None)
    _KNN(query.device, ref.data_ptr(), query.data_ptr(), B, R, Q,
         out.data_ptr(), None if d2 is None else d2.data_ptr())
    nn_indices.launches += 1
    return (out, d2) if return_d2 else out


nn_indices.launches = 0
