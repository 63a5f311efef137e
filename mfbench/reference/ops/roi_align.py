"""RoIAlign over the FPN levels P2-P5, in plain PyTorch, written from the
published description (He et al., ICCV 2017, section 3; the FPN's level
rule, Lin et al., CVPR 2017, eq. 1, with the 1e-6 inside the log as
ChainerCV writes it) and not from the port's code.

Each RoI ``(x1, y1, x2, y2)`` in input pixels goes to level ``k = floor(4 +
log2(sqrt(w h) / 224 + 1e-6))``, clamped to [2, 5]. On that level (scale
``2^-k``, ``aligned=False``) its extent, at least 1 a side, splits into
``P x P`` bins; each bin averages 2 x 2 regularly spaced bilinear samples.
A sample outside ``[-1, size]`` on an axis reads 0; one inside is clamped
at 0 and at the last row or column. The samples are read by index gathers
from each level's ``(C, H * W)`` plane, a block of RoIs at a time.
"""

from __future__ import annotations

import torch

STRIDES = (4, 8, 16, 32)
SAMPLING = 2
BLOCK = 128  # RoIs a gather


def levels(rois):
    """Each RoI's level, 0..3 for P2..P5."""
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    # / 224 as the product with its float32 reciprocal, which is how the
    # card divides a tensor by a number (the CPU divides exactly): the level
    # then comes out the same on both
    k = torch.floor(4 + torch.log2(torch.sqrt(w * h) * (1 / 224) + 1e-6))
    return torch.clamp(k, 2, 5).long() - 2


def _samples(lo, hi, size, P):
    """Sample positions along one axis: ``(n, P * SAMPLING)`` coordinates,
    their two taps, weights and whether they lie on the map."""
    extent = torch.clamp(hi - lo, min=1.0)
    step = extent / P
    k = torch.arange(P, dtype=torch.float32, device=lo.device)
    s = torch.arange(SAMPLING, dtype=torch.float32, device=lo.device)
    pos = ((lo[:, None] + k[None, :] * step[:, None])[:, :, None]
           + ((s + 0.5)[None, None, :] * step[:, None, None]) / SAMPLING)
    pos = pos.reshape(len(lo), P * SAMPLING)
    on_map = (pos >= -1) & (pos <= size)
    pos = pos.clamp(min=0)
    low = pos.long()
    at_end = low >= size - 1
    low = torch.where(at_end, torch.full_like(low, size - 1), low)
    pos = torch.where(at_end, low.float(), pos)
    high = torch.where(at_end, low, low + 1)
    frac = pos - low.float()
    return low, high, 1 - frac, frac, on_map


def _align(plane, rois, scale, P):
    """``(n, C, P, P)`` for ``rois`` on one level's ``(C, H, W)`` plane."""
    C, H, W = plane.shape
    n = len(rois)
    r = rois * scale
    y0, y1, wy0, wy1, oy = _samples(r[:, 1], r[:, 3], H, P)
    x0, x1, wx0, wx1, ox = _samples(r[:, 0], r[:, 2], W, P)
    flat = plane.reshape(C, H * W)

    def at(yi, xi):
        idx = yi[:, :, None] * W + xi[:, None, :]
        return flat[:, idx.reshape(-1)].reshape(C, n, yi.shape[1],
                                                xi.shape[1])

    value = (at(y0, x0) * (wy0[:, :, None] * wx0[:, None, :])
             + at(y0, x1) * (wy0[:, :, None] * wx1[:, None, :])
             + at(y1, x0) * (wy1[:, :, None] * wx0[:, None, :])
             + at(y1, x1) * (wy1[:, :, None] * wx1[:, None, :]))
    value = value * (oy[:, :, None] & ox[:, None, :])
    value = value.reshape(C, n, P, SAMPLING, P, SAMPLING).mean((3, 5))
    return value.permute(1, 0, 2, 3)


def roi_align(features, rois, P):
    """``features``: P2-P5 as ``(1, C, H, W)``; ``rois (R, 4)`` float32 ->
    ``(R, C, P, P)``."""
    C = features[0].shape[1]
    out = torch.zeros((len(rois), C, P, P), dtype=torch.float32,
                      device=rois.device)
    lv = levels(rois)
    for l, stride in enumerate(STRIDES):
        idx = torch.nonzero(lv == l)[:, 0]
        for a in range(0, len(idx), BLOCK):
            part = idx[a:a + BLOCK]
            out[part] = _align(features[l][0], rois[part], 1.0 / stride, P)
    return out
