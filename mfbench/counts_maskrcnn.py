"""The work of Mask R-CNN's two kernels and the FLOPs of its dense layers,
from the shapes and boxes of a frame, whatever implements them.

- :func:`roi_align_work`: one RoIAlign call (``csrc/roi_align.cu``): the
  union of the RoIs' footprints on each level (the feature elements, all
  channels, that any RoI's bilinear taps touch there) read once, however
  many RoIs share an element, the RoIs read once, each output written once;
  ~``12 * 4 + 1`` flops an output (a tap's weight and value products and
  sums, the average).
- :func:`nms_work`: one NMS call (``csrc/nms.cu``): every pair of a group's
  boxes at :data:`IOU_FLOPS`; the boxes (labels, flags) read once, the
  upper triangle of the bitmask written once and the keep flags written.
- :func:`frame_flops`: ``counts.count_flops`` on the reference model on the
  meta device at the cell's shapes: the fixed part (ResNet-50, FPN, RPN
  head, the box head on the proposals) and the mask head a detection.
"""

from __future__ import annotations

import numpy as np

from mfbench import counts

SAMPLING = 2
STRIDES = (4, 8, 16, 32)
IOU_FLOPS = 19  # 4 min/max, 2 + 2 clamped sides, inter, 2 areas, union, div
WORD = 64


def roi_levels(rois):
    f32 = np.float32
    w = (rois[:, 2] - rois[:, 0]).astype(f32)
    h = (rois[:, 3] - rois[:, 1]).astype(f32)
    s = np.sqrt(w * h, dtype=f32) * f32(1 / 224) + f32(1e-6)
    k = np.floor(f32(4) + np.log2(s, dtype=f32))
    return np.clip(k, 2, 5).astype(np.int64) - 2


def _taps(lo, hi, size, P):
    """``(n, 2 * P * SAMPLING)`` tap indices along an axis, -1 where the
    sample lies off the map."""
    f32 = np.float32
    extent = np.maximum(hi - lo, f32(1))
    step = extent * f32(1 / P)
    k = np.arange(P, dtype=f32)
    s = (np.arange(SAMPLING, dtype=f32) + f32(0.5))
    pos = ((lo[:, None] + k[None] * step[:, None])[:, :, None]
           + (s[None, None] * step[:, None, None]) / f32(SAMPLING))
    pos = pos.reshape(len(lo), -1)
    on = (pos >= -1) & (pos <= size)
    low = np.maximum(pos, 0).astype(np.int64)
    low = np.minimum(low, size - 1)
    high = np.minimum(low + 1, size - 1)
    taps = np.concatenate([low, high], 1)
    return np.where(np.concatenate([on, on], 1), taps, -1)


def _footprint(rows, cols, H, W):
    """Distinct ``(row, col)`` elements of an ``(H, W)`` map that the RoIs'
    taps touch: each RoI's rows x columns (``-1`` entries left out)."""
    touched = np.zeros((H, W), dtype=bool)
    for r, c in zip(rows, cols):
        touched[np.ix_(r[r >= 0], c[c >= 0])] = True
    return int(touched.sum())


def roi_align_work(rois, level_hw, C, P):
    """``(operations, bytes)`` of one RoIAlign call over ``rois (R, 4)``
    (input pixels) on levels of ``level_hw [(H, W)] * 4`` and ``C``
    channels, ``P x P`` bins."""
    rois = np.asarray(rois, np.float32).reshape(-1, 4)
    R = len(rois)
    levels = roi_levels(rois)
    footprint = 0
    for l, stride in enumerate(STRIDES):
        r = rois[levels == l] * np.float32(1.0 / stride)
        if not len(r):
            continue
        H, W = level_hw[l]
        footprint += _footprint(_taps(r[:, 1], r[:, 3], H, P),
                                _taps(r[:, 0], r[:, 2], W, P), H, W)
    outputs = R * C * P * P
    ops = outputs * (12 * SAMPLING * SAMPLING + 1)
    bytes_moved = 4 * (footprint * C + 4 * R + outputs)
    return ops, bytes_moved


def nms_work(group_sizes, labels=False):
    """``(operations, bytes)`` of one NMS call over groups of
    ``group_sizes`` boxes (with a label a box where ``labels``)."""
    n = np.asarray(group_sizes, np.int64)
    pairs = int((n * (n - 1) // 2).sum())
    mask_words = 0
    for g in n.tolist():
        blocks = -(-g // WORD)
        for rb in range(blocks):
            rows = min(WORD, g - rb * WORD)
            mask_words += rows * (blocks - rb)
    N = int(n.sum())
    bytes_moved = N * (16 + (4 if labels else 0) + 1 + 1) + 8 * mask_words
    return IOU_FLOPS * pairs, bytes_moved


def frame_flops(config, image_hw, proposals):
    """``(fixed, per_detection)`` FLOPs of a frame's dense layers: ResNet-50,
    FPN and RPN head at the padded input ``image_hw``, the box head on
    ``proposals`` RoIs; the mask head on one RoI."""
    import torch

    from mfbench.reference.models import maskrcnn as plain

    meta = torch.device("meta")
    kw = config["kwargs"]
    with meta:
        model = plain.MaskRCNN(**kw)
    C = kw.get("fpn_channels", 256)
    box, mask = plain.BOX_POOL, plain.MASK_POOL

    def fixed():
        with torch.no_grad():
            ps = model.features(torch.empty((1, 3, *image_hw), device=meta))
            model.rpn(ps)
            model.box_head(torch.empty((proposals, C, box, box), device=meta))

    def one():
        with torch.no_grad():
            model.mask_head(torch.empty((1, C, mask, mask), device=meta))

    return counts.count_flops(fixed), counts.count_flops(one)


def roofline(run, names, key):
    """Share (%) of the least time the traced frames' calls of a kernel
    need (their ``work[key]``) in the device time of the kernels named by
    any of ``names`` there; None where none ran."""
    from mfbench import readers

    prof = run.record.profile
    if prof is None:
        return None
    seconds = prof.op_seconds(lambda n: any(k in n for k in names))
    least = sum(counts.least_seconds(*w)
                for u in readers.profiled_units(run)
                for w in u.get("work", {}).get(key, []))
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
