"""The pose node's device crop and its host bounding boxes: frozen copies of
``morefusion_tpu_torch/runtime/pose_estimation.py::_crop_instance_device``
and ``morefusion_tpu_torch/geometry/bbox.py::masks_to_bboxes``.
"""

from __future__ import annotations

import numpy as np
import torch


def masks_to_bboxes(masks: np.ndarray) -> np.ndarray:
    """Boolean mask image(s) -> ``(y1, x1, y2, x2)`` boxes.

    ``(H, W)`` -> ``(4,)``; ``(N, H, W)`` -> ``(N, 4)``. Empty masks give
    all-zero boxes.
    """
    masks = np.asarray(masks)
    if masks.dtype != bool or masks.ndim not in (2, 3):
        raise ValueError("masks must be a bool array of 2 or 3 dimensions")
    ndim = masks.ndim
    if ndim == 2:
        masks = masks[None]
    bboxes = np.zeros((len(masks), 4), dtype=np.float64)
    for i, mask in enumerate(masks):
        rows = mask.any(axis=1)
        if not rows.any():
            continue
        y_idx = np.flatnonzero(rows)
        x_idx = np.flatnonzero(mask.any(axis=0))
        bboxes[i] = y_idx[0], x_idx[0], y_idx[-1] + 1, x_idx[-1] + 1
    return bboxes[0] if ndim == 2 else bboxes


def _crop_instance_device(rgb_frame, pcd_frame, label, ins_ids, bboxes,
                          image_size: int):
    """Mask, crop and centre each instance at ``image_size``^2 on the device.

    ``rgb_frame (H, W, 3)``, ``pcd_frame (H, W, 3)``, ``label (H, W)``,
    ``ins_ids (B,)``, ``bboxes (B, 4)`` as ``(y1, x1, y2, x2)`` ->
    ``rgb (B, S, S, 3)`` float32 and ``pcd (B, S, S, 3)`` (NaN off the
    instance). The resize keeps the aspect ratio and pads at the centre with
    cv2's conventions: INTER_LINEAR for rgb, whose off-mask pixels count as
    0, and INTER_NEAREST for the cloud.
    """
    S = image_size
    device = rgb_frame.device
    y1, x1, y2, x2 = bboxes.to(torch.int64).unbind(dim=1)
    ins = ins_ids[:, None, None]
    Hb = (y2 - y1).to(torch.float32)
    Wb = (x2 - x1).to(torch.float32)
    scale = torch.minimum(S / Hb, S / Wb)
    h = torch.clamp(torch.round(Hb * scale), 1, S).to(torch.int64)
    w = torch.clamp(torch.round(Wb * scale), 1, S).to(torch.int64)
    y0 = torch.div(S - h, 2, rounding_mode="floor")
    x0 = torch.div(S - w, 2, rounding_mode="floor")
    ys = torch.arange(S, device=device)
    vy = (ys >= y0[:, None]) & (ys < (y0 + h)[:, None])  # (B, S)
    vx = (ys >= x0[:, None]) & (ys < (x0 + w)[:, None])
    valid = vy[:, :, None] & vx[:, None, :]  # (B, S, S)
    ry = (Hb / h)[:, None]
    rx = (Wb / w)[:, None]

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo[:, None]), hi[:, None])

    # nearest: src = floor(dst * src/dst), clamped to the bbox
    sy = clip(y1[:, None] + torch.floor((ys - y0[:, None]) * ry).long(),
              y1, y2 - 1)
    sx = clip(x1[:, None] + torch.floor((ys - x0[:, None]) * rx).long(),
              x1, x2 - 1)
    mask = (label[sy[:, :, None], sx[:, None, :]] == ins) & valid
    pcd_c = pcd_frame[sy[:, :, None], sx[:, None, :]]
    pcd_c = torch.where(mask[..., None], pcd_c, float("nan"))

    # bilinear: fsrc = (dst + 0.5) * src/dst - 0.5; a corner off the
    # instance mask contributes 0
    ysf = ys.to(torch.float32)
    fy = (ysf - y0[:, None] + 0.5) * ry - 0.5
    fx = (ysf - x0[:, None] + 0.5) * rx - 0.5
    zero = torch.zeros_like(Hb)
    fy = clip(fy, zero, Hb - 1.0) + y1[:, None]
    fx = clip(fx, zero, Wb - 1.0) + x1[:, None]
    fy0, fx0 = torch.floor(fy), torch.floor(fx)
    wy = (fy - fy0)[:, :, None]
    wx = (fx - fx0)[:, None, :]
    iy0, ix0 = fy0.long(), fx0.long()
    iy1 = torch.minimum(iy0 + 1, (y2 - 1)[:, None])
    ix1 = torch.minimum(ix0 + 1, (x2 - 1)[:, None])

    def corner(iy, ix):
        r = rgb_frame[iy[:, :, None], ix[:, None, :]].to(torch.float32)
        m = label[iy[:, :, None], ix[:, None, :]] == ins
        return r * m[..., None]

    rgb_c = (
        corner(iy0, ix0) * ((1 - wy) * (1 - wx))[..., None]
        + corner(iy0, ix1) * ((1 - wy) * wx)[..., None]
        + corner(iy1, ix0) * (wy * (1 - wx))[..., None]
        + corner(iy1, ix1) * (wy * wx)[..., None]
    )
    return rgb_c * valid[..., None], pcd_c
