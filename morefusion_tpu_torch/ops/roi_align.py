"""Multi-level RoIAlign (``aligned=False``, sampling ratio 2) over the FPN
levels P2-P5: the CUDA kernel and its plain version.

Replaces no TPU kernel: the JAX package has no detector. The kernel is
``csrc/roi_align.cu`` (its header says what bounds it and how it is laid
out); :func:`roi_align_plain` is its plain version. ``models/maskrcnn.py``
calls :func:`roi_align` twice a frame: 7 x 7 for the box head over the
proposals, 14 x 14 for the mask head over the detections.

Contract, for ``features``, the four levels P2-P5 as ``(1, C, H_l, W_l)``
float32 (strides 4, 8, 16, 32), and ``rois (R, 4)`` float32 ``x1, y1, x2,
y2`` in input pixels (finite, ``x2 >= x1``, ``y2 >= y1``): ``(R, C, P, P)``
float32. Each RoI reads the level :func:`roi_levels` gives it; its bins
average a 2 x 2 grid of bilinear samples with the edge rules of the
original RoIAlign (the csrc header states them). Every operation is rounded
apart as written in :func:`roi_align_plain`: the kernel gives the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SAMPLING = 2
STRIDES = (4, 8, 16, 32)  # P2-P5
CANONICAL_SIZE = 224.0
CANONICAL_LEVEL = 4
_ptr, _int = ctypes.c_void_p, ctypes.c_int
_ROI_ALIGN = _build.Kernel("mfk_roi_align", [_ptr, _ptr, _int, _ptr, _int,
                                             _int, _ptr, _int, _ptr])


def roi_levels(rois):
    """Each RoI's level as an index into P2-P5: ``floor(4 + log2(sqrt(wh) /
    224 + 1e-6))`` clamped to [2, 5], minus 2; int64. The division is the
    product with the float32 reciprocal, as the card divides by a scalar
    (the CPU divides exactly): the same bits on both."""
    area = (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])
    k = torch.floor(CANONICAL_LEVEL + torch.log2(
        torch.sqrt(area) * (1.0 / CANONICAL_SIZE) + 1e-6))
    return k.clamp(2, 5).to(torch.int64) - 2


def _axis_samples(start, bin_size, n_bins):
    """``(R, n_bins * SAMPLING)`` sample coordinates of an axis: bin ``p``,
    sample ``s`` at ``(start + p * bin) + ((s + 0.5) * bin) / SAMPLING``."""
    p = torch.arange(n_bins, dtype=torch.float32, device=start.device)
    s = torch.arange(SAMPLING, dtype=torch.float32, device=start.device)
    base = start[:, None] + p[None, :] * bin_size[:, None]  # (R, n_bins)
    off = ((s + 0.5)[None, :] * bin_size[:, None]) / SAMPLING  # (R, S)
    return (base[:, :, None] + off[:, None, :]).reshape(len(start), -1)


def _axis_taps(coord, size):
    """The two taps, their weights and the in-range flag of each sample
    coordinate along an axis of ``size``."""
    inside = (coord >= -1.0) & (coord <= size)
    c = torch.where(coord <= 0, torch.zeros_like(coord), coord)
    low = c.to(torch.int64)
    last = low >= size - 1
    low = torch.where(last, torch.full_like(low, size - 1), low)
    high = torch.where(last, low, low + 1)
    c = torch.where(last, low.to(torch.float32), c)
    lw = c - low.to(torch.float32)
    return low, high, 1.0 - lw, lw, inside


def _one_level(feature, rois, P, scale):
    """RoIAlign of ``rois`` on one level ``(1, C, H, W)`` at ``scale``."""
    _, C, H, W = feature.shape
    R = rois.shape[0]
    start_w, start_h = rois[:, 0] * scale, rois[:, 1] * scale
    roi_w = torch.clamp(rois[:, 2] * scale - start_w, min=1.0)
    roi_h = torch.clamp(rois[:, 3] * scale - start_h, min=1.0)
    ys = _axis_samples(start_h, roi_h * (1.0 / P), P)  # (R, P * S)
    xs = _axis_samples(start_w, roi_w * (1.0 / P), P)
    y0, y1, hy, ly, iny = _axis_taps(ys, H)
    x0, x1, hx, lx, inx = _axis_taps(xs, W)
    f = feature[0].reshape(C, H * W)

    def tap(yi, xi):  # (R, PS, PS) -> (C, R, PS, PS)
        idx = (yi[:, :, None] * W + xi[:, None, :]).reshape(-1)
        return f[:, idx].reshape(C, R, yi.shape[1], xi.shape[1])

    v = (hy[:, :, None] * hx[:, None, :]) * tap(y0, x0)
    v = v + (hy[:, :, None] * lx[:, None, :]) * tap(y0, x1)
    v = v + (ly[:, :, None] * hx[:, None, :]) * tap(y1, x0)
    v = v + (ly[:, :, None] * lx[:, None, :]) * tap(y1, x1)
    v = torch.where(iny[:, :, None] & inx[:, None, :], v, torch.zeros_like(v))
    # (C, R, P, S, P, S): sum the samples in order, iy outer
    v = v.reshape(C, R, P, SAMPLING, P, SAMPLING)
    total = torch.zeros((C, R, P, P), dtype=torch.float32,
                        device=feature.device)
    for iy in range(SAMPLING):
        for ix in range(SAMPLING):
            total = total + v[:, :, :, iy, :, ix]
    return (total / (SAMPLING * SAMPLING)).permute(1, 0, 2, 3)


def roi_align_plain(features, rois, output_size):
    """The kernel's arithmetic in PyTorch, level by level."""
    _check_args(features, rois)
    P = int(output_size)
    C = features[0].shape[1]
    out = torch.zeros((rois.shape[0], C, P, P), dtype=torch.float32,
                      device=rois.device)
    levels = roi_levels(rois)
    for l, (feature, stride) in enumerate(zip(features, STRIDES)):
        pick = torch.nonzero(levels == l)[:, 0]
        if len(pick):
            out[pick] = _one_level(feature, rois[pick], P, 1.0 / stride)
    return out


def _check_args(features, rois):
    if len(features) != len(STRIDES):
        raise ValueError(f"{len(STRIDES)} levels (P2-P5), got "
                         f"{len(features)}")
    C = features[0].shape[1]
    for f in features:
        if f.dim() != 4 or f.shape[0] != 1 or f.shape[1] != C or \
                f.dtype != torch.float32:
            raise ValueError(f"each level must be float32 (1, {C}, H, W), "
                             f"got {f.dtype} {tuple(f.shape)}")
        if f.device != rois.device:
            raise ValueError(f"a level lies on {f.device}, rois on "
                             f"{rois.device}")
    if rois.dim() != 2 or rois.shape[1] != 4 or rois.dtype != torch.float32:
        raise ValueError(f"rois must be float32 (R, 4), got {rois.dtype} "
                         f"{tuple(rois.shape)}")


def roi_align(features, rois, output_size):
    """RoIAlign of ``rois`` over P2-P5, as the contract above says."""
    _check_args(features, rois)
    if not _build.on_card(rois, "roi_align"):
        return roi_align_plain(features, rois, output_size)
    P = int(output_size)
    C = features[0].shape[1]
    features = [f.contiguous() for f in features]
    rois = rois.contiguous()
    out = torch.empty((rois.shape[0], C, P, P), dtype=torch.float32,
                      device=rois.device)
    ptrs = (ctypes.c_void_p * len(STRIDES))(*[f.data_ptr() for f in features])
    hw = (ctypes.c_int * (2 * len(STRIDES)))(
        *[d for f in features for d in f.shape[-2:]])
    _ROI_ALIGN(rois.device, ptrs, hw, C, rois.data_ptr(), rois.shape[0], P,
               out.data_ptr())
    roi_align.launches += 1
    return out


roi_align.launches = 0
