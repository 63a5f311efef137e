"""Greedy non-maximum suppression over groups of score-sorted boxes: the
CUDA kernel and its plain version.

Replaces no TPU kernel: the JAX package has no detector. The kernel is
``csrc/nms.cu`` (its header says what bounds it and how it is laid out);
:func:`nms_plain` is its plain version. ``models/maskrcnn.py`` calls
:func:`nms` twice a frame: the proposals within each pyramid level, the
detections within each class.

Contract, for ``boxes (N, 4)`` float32 ``x1, y1, x2, y2``, groups
``[(start, count), ...]`` (host integers, at most 32 groups; by default one
group of all ``N``), each group's rows sorted by score (ties to the lower
index), optional ``labels (N,)`` int32 and ``valid (N,)`` bool: ``(N,)``
bool, whether each box is kept. Within a group, in order, a valid box that
no kept box suppressed is kept, and suppresses each later box of its group
with the same label whose :func:`iou` with it exceeds ``threshold`` (float32),
every operation rounded apart as written there: the kernel gives the same
bits. An invalid box is neither kept nor suppresses. Rows outside every
group come back False.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

WORD = 64  # boxes a word of the kernel's bitmask
MAX_GROUPS = 32
# the scan stages (64 + 1) x words of 8 bytes in 48 KB of shared memory
MAX_GROUP_SIZE = (48 * 1024 // (8 * (WORD + 1))) * WORD
_ptr, _int = ctypes.c_void_p, ctypes.c_int
_NMS = _build.Kernel("mfk_nms", [_ptr, _ptr, _ptr, _int, _ptr, _ptr, _int,
                                 ctypes.c_float, _ptr, _ptr, _int, _ptr])


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def iou(box, boxes):
    """IoU of one box ``(4,)`` with each of ``boxes (n, 4)``: inter /
    ((area + areas) - inter), float32, each operation rounded apart."""
    w = (torch.minimum(box[2], boxes[:, 2])
         - torch.maximum(box[0], boxes[:, 0])).clamp(min=0)
    h = (torch.minimum(box[3], boxes[:, 3])
         - torch.maximum(box[1], boxes[:, 1])).clamp(min=0)
    inter = w * h
    return inter / ((box_area(box) + box_area(boxes)) - inter)


def _groups(n, groups):
    groups = [(0, n)] if groups is None else [(int(a), int(c))
                                              for a, c in groups]
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"at most {MAX_GROUPS} groups, got {len(groups)}")
    for a, c in groups:
        if a < 0 or c < 0 or a + c > n:
            raise ValueError(f"group ({a}, {c}) lies outside {n} boxes")
        if c > MAX_GROUP_SIZE:
            raise ValueError(f"at most {MAX_GROUP_SIZE} boxes a group, "
                             f"got {c}")
    return groups


def _check_args(boxes, labels, valid):
    if boxes.dtype != torch.float32 or boxes.dim() != 2 or \
            boxes.shape[1] != 4:
        raise ValueError(f"boxes must be float32 (N, 4), got {boxes.dtype} "
                         f"{tuple(boxes.shape)}")
    N = boxes.shape[0]
    if labels is not None and (labels.shape != (N,)
                               or labels.dtype != torch.int32):
        raise ValueError("labels must be int32 (N,)")
    if valid is not None and (valid.shape != (N,)
                              or valid.dtype != torch.bool):
        raise ValueError("valid must be bool (N,)")
    for name, t in (("labels", labels), ("valid", valid)):
        if t is not None and t.device != boxes.device:
            raise ValueError(f"{name} lies on {t.device}, boxes on "
                             f"{boxes.device}")


def nms_plain(boxes, threshold, groups=None, labels=None, valid=None):
    """The greedy walk, box by box, on the kernel's arithmetic."""
    _check_args(boxes, labels, valid)
    N = boxes.shape[0]
    keep = torch.zeros(N, dtype=torch.bool, device=boxes.device)
    thr = torch.tensor(threshold, dtype=torch.float32)
    boxes_h = boxes.cpu()
    valid_h = (torch.ones(N, dtype=torch.bool) if valid is None
               else valid.cpu())
    labels_h = None if labels is None else labels.cpu()
    for start, count in _groups(N, groups):
        b = boxes_h[start:start + count]
        removed = ~valid_h[start:start + count].clone()
        for i in range(count):
            if removed[i]:
                continue
            keep[start + i] = True
            hit = iou(b[i], b[i + 1:]) > thr
            if labels_h is not None:
                lab = labels_h[start:start + count]
                hit &= lab[i + 1:] == lab[i]
            removed[i + 1:] |= hit
    return keep


def nms(boxes, threshold, groups=None, labels=None, valid=None):
    """Whether each box is kept, as the contract above says. The launcher
    runs two kernels; ``nms.launches`` counts the call once."""
    _check_args(boxes, labels, valid)
    if not _build.on_card(boxes, "nms"):
        return nms_plain(boxes, threshold, groups, labels, valid)
    N = boxes.shape[0]
    groups = _groups(N, groups)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    words = max(1, max((c + WORD - 1) // WORD for _, c in groups))
    mask = torch.empty((N, words), dtype=torch.int64, device=boxes.device)
    keep = torch.zeros(N, dtype=torch.uint8, device=boxes.device)
    if labels is not None:
        labels = labels.contiguous()
    if valid is not None:
        valid = valid.contiguous().view(torch.uint8)
    G = len(groups)
    starts = (ctypes.c_int * MAX_GROUPS)(*[a for a, _ in groups])
    counts = (ctypes.c_int * MAX_GROUPS)(*[c for _, c in groups])
    _NMS(boxes.device, boxes.data_ptr(),
         None if labels is None else labels.data_ptr(),
         None if valid is None else valid.data_ptr(), G, starts, counts,
         words, threshold, mask.data_ptr(), keep.data_ptr())
    nms.launches += 1
    return keep.view(torch.bool)


nms.launches = 0
