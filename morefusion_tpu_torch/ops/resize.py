"""Bilinear upsampling, ``align_corners=False``, of NCHW tensors: the CUDA
kernel and its plain version.

Replaces no TPU kernel: the JAX package resizes with ``jax.image.resize``,
which XLA lowers by itself. The kernel is ``csrc/resize.cu`` (its header
says what bounds it and how it is laid out), forward and backward;
:func:`resize_bilinear_plain` (``F.interpolate``) is its plain version.
PSPNet's pyramid and x2 stages and the UNet segmenter's x2 stages call
:func:`resize_bilinear`.

Contract, for ``x (N, C, H, W)`` float32 or bfloat16, contiguous, and an
output size ``h >= H``, ``w >= W``: ``F.interpolate(x, (h, w),
mode="bilinear", align_corners=False)``, computed in float32 whatever the
storage type, bit for bit in the forward (an exact x2 in both axes takes a
stencil path, any other size the general rule; equal sizes copy, as
PSPNet's 6-bin level does where the feature map is 6-11 wide). The
backward gathers: each input element sums the outputs that read it, in a
fixed order, with no atomics, so it equals ``F.interpolate``'s backward
within float32 rounding of a reordered sum and is the same on every run.

:func:`axis_taps`, :func:`readers`, :func:`gather_weights` and
:func:`x2_weights` mirror the kernel's index arithmetic along one axis in
numpy (each float32 operation rounded apart);
:func:`resize_bilinear_backward_plain` is the backward's gather in PyTorch
on those ranges and weights.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiling
from . import _build

# storage types the kernel takes, as its launchers number them
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_ptr, _ptr, _int, ctypes.c_longlong, _int, _int, _int, _int,
             _int, _ptr]
_FORWARD = _build.Kernel("mfk_resize_forward", _ARGTYPES)
_BACKWARD = _build.Kernel("mfk_resize_backward", _ARGTYPES)
_KERNELS = {k.name: k for k in (_FORWARD, _BACKWARD)}


def resize_bilinear_plain(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def axis_taps(n_in, n_out):
    """F.interpolate's rule for each output index ``o`` of an axis that
    goes from ``n_in`` to ``n_out``: ``(i0, i1, l0, l1)``, the two input
    indices it reads and their float32 weights."""
    f32 = np.float32
    scale = f32(n_in) / f32(n_out)
    src = scale * (np.arange(n_out, dtype=f32) + f32(0.5)) - f32(0.5)
    src = np.maximum(src, f32(0))
    i0 = src.astype(np.int64)
    i1 = i0 + (i0 < n_in - 1)
    l1 = src - i0.astype(f32)
    return i0, i1, f32(1) - l1, l1


def readers(n_in, n_out):
    """``(lo, hi)`` for each input index ``i``: the outputs that read it
    are ``lo .. hi``, those whose ``i0`` is ``i - 1`` or ``i``."""
    i0 = axis_taps(n_in, n_out)[0]
    i = np.arange(n_in)
    return (np.searchsorted(i0, i - 1, "left"),
            np.searchsorted(i0, i, "right") - 1)


def gather_weights(n_in, n_out):
    """``(n_in, n_out)`` float32: the weight with which output ``o`` reads
    input ``i`` (``l0`` where ``i0 == i`` plus ``l1`` where ``i1 == i``),
    over each input's readers; 0 outside them."""
    i0, i1, l0, l1 = axis_taps(n_in, n_out)
    out = np.zeros((n_in, n_out), np.float32)
    for i, (lo, hi) in enumerate(zip(*readers(n_in, n_out))):
        o = np.arange(lo, hi + 1)
        out[i, o] = (np.where(i0[o] == i, l0[o], np.float32(0))
                     + np.where(i1[o] == i, l1[o], np.float32(0)))
    return out


def x2_weights(n_in):
    """The kernel's fixed x2 table as :func:`gather_weights` lays it out:
    input ``i`` is read by output ``2i-2`` at 0 (only where ``i == 1``),
    ``2i-1`` at 1/4 (``i >= 1``), ``2i`` at 3/4 (1 where ``i == 0``),
    ``2i+1`` at 3/4 (1 where ``i`` is the last), ``2i+2`` at 1/4 (``i <=
    n_in - 2``)."""
    out = np.zeros((n_in, 2 * n_in), np.float32)
    for i in range(n_in):
        if i >= 1:
            out[i, 2 * i - 1] = 0.25
        out[i, 2 * i] = 1.0 if i == 0 else 0.75
        out[i, 2 * i + 1] = 1.0 if i == n_in - 1 else 0.75
        if i <= n_in - 2:
            out[i, 2 * i + 2] = 0.25
    return out


def resize_bilinear_backward_plain(grad, h, w):
    """The kernel's backward in PyTorch: ``grad (N, C, Ho, Wo)`` to the
    gradient of an ``(N, C, h, w)`` input, each input element the sum of
    ``(wh * ww) * grad`` over the outputs that read it, with the kernel's
    weights (the x2 table where both axes grow x2)."""
    Ho, Wo = grad.shape[-2:]
    if (Ho, Wo) == (2 * h, 2 * w):
        wh, ww = x2_weights(h), x2_weights(w)
    else:
        wh, ww = gather_weights(h, Ho), gather_weights(w, Wo)
    wh = torch.from_numpy(wh).to(grad)
    ww = torch.from_numpy(ww).to(grad)
    return torch.einsum("ip,jq,ncpq->ncij", wh, ww, grad)


def _check_kernel_args(x, h, w):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"no resize kernel for {x.dtype}: float32 or "
                         f"bfloat16")
    H, W = x.shape[-2:]
    if H < 1 or W < 1 or h < H or w < W:
        raise ValueError(f"the resize kernel upsamples only: {H}x{W} to "
                         f"{h}x{w}")
    if h * w >= 2**31:
        raise ValueError(f"at most 2**31 - 1 outputs a plane, got {h}x{w}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NCHW")


def _launch(name, src, dst, in_hw, out_hw):
    _KERNELS[name](src.device, src.data_ptr(), dst.data_ptr(),
                   _KERNEL_DTYPES[src.dtype], src.shape[0] * src.shape[1],
                   *in_hw, *out_hw)
    resize_bilinear.launches += 1


class _Resize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, w):
        ctx.in_hw = tuple(x.shape[-2:])
        y = torch.empty((*x.shape[:2], h, w), dtype=x.dtype, device=x.device)
        _launch("mfk_resize_forward", x, y, ctx.in_hw, (h, w))
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        grad = grad.contiguous()
        gx = torch.empty((*grad.shape[:2], *ctx.in_hw), dtype=grad.dtype,
                         device=grad.device)
        _launch("mfk_resize_backward", grad, gx, ctx.in_hw,
                tuple(grad.shape[-2:]))
        return gx, None, None


def resize_bilinear(x, h, w):
    """``F.interpolate(x, (h, w), bilinear, align_corners=False)``.

    ``resize_bilinear.launches`` counts the forward's and the backward's
    launches; under a profiler, the counter ``resize.calls`` counts every
    call and ``resize.kernel`` those the kernel takes.
    """
    profiling.count("resize.calls")
    if not _build.on_card(x, "resize"):
        return resize_bilinear_plain(x, h, w)
    _check_kernel_args(x, h, w)
    profiling.count("resize.kernel")
    return _Resize.apply(x, h, w)


resize_bilinear.launches = 0
