"""Each instance's box and count of finite points in one frame: the CUDA
kernel and its plain version.

Replaces no TPU kernel: the JAX package selects the instances on the host.
The kernel is ``csrc/instance_boxes.cu`` (its header says what bounds it
and how it is laid out); :func:`instance_boxes_plain` is its plain version.
``runtime/pose_estimation.py::PoseEstimationNode.dispatch`` calls
:func:`instance_boxes` once a frame to choose the instances it poses.

Contract, for ``label (H, W)`` int32, ``pcd (H, W, 3)`` float32 and ``ids
(K,)`` int32 on one device: ``(K, 5)`` int32 ``(y1, x1, y2, x2,
n_finite)``, row ``k`` the box of the pixels where ``label == ids[k]`` as
``geometry/bbox.py::masks_to_bboxes`` gives it (first row and column, last
row and column + 1; all zero where there is none) and how many of those
pixels have a cloud point with no NaN component. Integers only: the kernel
gives the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_IDS = 1024  # ids a launch (the kernel's shared memory); more are split
_ptr, _int = ctypes.c_void_p, ctypes.c_int
_INSTANCE_BOXES = _build.Kernel("mfk_instance_boxes", [
    _ptr, _ptr, _ptr, _int, _int, _int, _ptr, _ptr, _int, _ptr])


def _check_args(label, pcd, ids):
    if label.dtype != torch.int32 or label.dim() != 2:
        raise ValueError(f"label must be int32 (H, W), got {label.dtype} "
                         f"{tuple(label.shape)}")
    if pcd.dtype != torch.float32 or pcd.shape != (*label.shape, 3):
        raise ValueError(f"pcd must be float32 {(*label.shape, 3)}, got "
                         f"{pcd.dtype} {tuple(pcd.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"ids must be int32 (K,), got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    for name, t in (("pcd", pcd), ("ids", ids)):
        if t.device != label.device:
            raise ValueError(f"{name} lies on {t.device}, label on "
                             f"{label.device}")


def instance_boxes_plain(label, pcd, ids):
    """Each id's mask over the whole frame, its rows' and columns' first
    and last hit, and its finite pixels' count."""
    _check_args(label, pcd, ids)
    H, W = label.shape
    hit = label[None] == ids[:, None, None]  # (K, H, W)
    rows, cols = hit.any(2), hit.any(1)
    ys = torch.arange(H, device=label.device)
    xs = torch.arange(W, device=label.device)
    y1 = torch.where(rows, ys, H).amin(1)
    x1 = torch.where(cols, xs, W).amin(1)
    y2 = torch.where(rows, ys + 1, 0).amax(1)
    x2 = torch.where(cols, xs + 1, 0).amax(1)
    empty = y2 == 0
    y1 = torch.where(empty, 0, y1)
    x1 = torch.where(empty, 0, x1)
    finite = ~torch.isnan(pcd).any(2)
    n = (hit & finite).sum((1, 2))
    return torch.stack([y1, x1, y2, x2, n], 1).to(torch.int32)


def instance_boxes(label, pcd, ids):
    """Each id's box and finite count, as the contract above says: one
    launch, counted in ``instance_boxes.launches``, per ``MAX_IDS`` ids."""
    _check_args(label, pcd, ids)
    if not _build.on_card(label, "instance_boxes"):
        return instance_boxes_plain(label, pcd, ids)
    K = ids.shape[0]
    H, W = label.shape
    if K == 0 or H * W == 0:
        return torch.zeros((K, 5), dtype=torch.int32, device=label.device)
    out = torch.empty((K, 5), dtype=torch.int32, device=label.device)
    label, pcd, ids = label.contiguous(), pcd.contiguous(), ids.contiguous()
    for s in range(0, K, MAX_IDS):
        k = min(MAX_IDS, K - s)
        acc = torch.empty(5 * k + 1, dtype=torch.int32, device=label.device)
        _INSTANCE_BOXES(label.device, label.data_ptr(), pcd.data_ptr(),
                        ids[s:].data_ptr(), k, H, W, acc.data_ptr(),
                        out[s:].data_ptr())
        instance_boxes.launches += 1
    return out


instance_boxes.launches = 0
