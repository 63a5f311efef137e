"""Instance tracking: match detected masks to mapped instances by IoU.

Own copy of ``morefusion_tpu/runtime/tracking.py``. ``cv2`` is imported
only by the contour filter, which runs with ``size_filter=True``; where
``cv2`` is missing that filter raises ``ImportError`` and is never skipped.
NumPy/cv2 port of the reference's C++ tracking utilities
(``ros/src/morefusion_ros/include/morefusion_ros/utils/geometry.h``):
``mask_to_bbox`` (:22-40), ``is_detected_mask_too_small`` (:42-77), and
``track_instance_id`` (:79-230): detections are matched to the raycast-
rendered map labels by IoU (>= 0.4) or coverage (>= 0.9); unmatched
non-suspicious detections get fresh instance ids; detections that are too
small or dominated by the image border are suppressed (label -2).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "size_filter=True needs OpenCV (cv2) for its contour filter; "
            "install it or pass size_filter=False"
        ) from e
    return cv2


def mask_to_bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return (mask.shape[0] - 1, mask.shape[1] - 1, 0, 0)
    return (
        max(int(ys.min()) - 1, 0),
        max(int(xs.min()) - 1, 0),
        min(int(ys.max()) + 1, mask.shape[0] - 1),
        min(int(xs.max()) + 1, mask.shape[1] - 1),
    )


def is_detected_mask_too_small(mask: np.ndarray) -> bool:
    """Reject small/noisy detections (reference thresholds, scaled to the
    image area: the C++ constants assume 480x640)."""
    cv2 = _cv2()
    m = mask.astype(np.uint8)
    contours, _ = cv2.findContours(
        m, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE
    )
    for i, c in enumerate(contours):
        if cv2.contourArea(c) < 20 * 20:
            cv2.drawContours(m, contours, i, color=0, thickness=-1)

    scale = np.sqrt(mask.shape[0] * mask.shape[1] / (480.0 * 640.0))
    y1, x1, y2, x2 = mask_to_bbox(m.astype(bool))
    bh, bw = y2 - y1, x2 - x1
    mask_size = int(m.sum())
    bbox_size = bh * bw
    return (
        mask_size < (40 * scale) ** 2
        or bbox_size < (80 * scale) ** 2
        or bh < 60 * scale
        or bw < 60 * scale
    )


def track_instance_id(
    reference: np.ndarray,
    target: np.ndarray,
    instance_id_to_class_id: Dict[int, int],
    instance_counter: int,
    size_filter: bool = True,
) -> Tuple[np.ndarray, Dict[int, int], int]:
    """Match detection labels (``target``) to map labels (``reference``).

    Args:
      reference: (H, W) int labels rendered from the map (<0 = none).
      target: (H, W) int labels from the detector (<0 = none).
      instance_id_to_class_id: class of each *detection* id in ``target``.
      instance_counter: next fresh global instance id.

    Returns:
      (relabeled target, {global instance id: class id}, new counter).
      Suppressed pixels get -2.
    """
    target = target.copy()
    H, W = reference.shape

    mask_nonedge = np.zeros((H, W), bool)
    mask_nonedge[
        int(H * 0.1) : int(H * 0.9), int(W * 0.1) : int(W * 0.9)
    ] = True
    mask_edge = ~mask_nonedge

    ids1 = [i for i in np.unique(reference) if i >= 0]
    ids2 = [i for i in np.unique(target) if i >= 0]

    ins_id2to1: Dict[int, Tuple[int, float, float]] = {}
    suspicious2 = set()
    for ins_id2 in ids2:
        mask2 = target == ins_id2
        ins_id2to1[ins_id2] = (-1, 0.0, 0.0)

        if size_filter and is_detected_mask_too_small(mask2):
            suspicious2.add(ins_id2)
        if (mask2 & mask_edge).sum() > (mask2 & mask_nonedge).sum():
            suspicious2.add(ins_id2)

        for ins_id1 in ids1:
            mask1 = reference == ins_id1
            inter = (mask1 & mask2).sum()
            union = (mask1 | mask2).sum()
            iou = inter / union if union else 0.0
            coverage = inter / mask1.sum() if mask1.sum() else 0.0
            if iou > ins_id2to1[ins_id2][1]:
                ins_id2to1[ins_id2] = (int(ins_id1), float(iou), coverage)

    # new instances for unmatched, trustworthy detections
    for ins_id2, (ins_id1, iou, coverage) in list(ins_id2to1.items()):
        if ins_id2 in suspicious2:
            continue
        if iou >= 0.4 or coverage >= 0.9:
            continue
        ins_id2to1[ins_id2] = (instance_counter, iou, coverage)
        instance_counter += 1

    updated: Dict[int, int] = {}
    for ins_id2, class_id in instance_id_to_class_id.items():
        if ins_id2 in suspicious2 or ins_id2 not in ins_id2to1:
            continue
        updated[ins_id2to1[ins_id2][0]] = class_id

    # relabel target
    out = np.full_like(target, -1)
    out[target < 0] = target[target < 0]
    out[(target < 0) & mask_edge] = -2
    for ins_id2 in ids2:
        m = target == ins_id2
        if ins_id2 in suspicious2:
            out[m] = -2
        else:
            out[m] = ins_id2to1[ins_id2][0]

    # suppress small blobs of the relabeled map
    if size_filter:
        cv2 = _cv2()
        for ins_id in [i for i in np.unique(out) if i >= 0]:
            m = (out == ins_id).astype(np.uint8)
            contours, _ = cv2.findContours(
                m, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE
            )
            for j, c in enumerate(contours):
                if cv2.contourArea(c) < 20 * 20:
                    cv2.drawContours(
                        out, contours, j, color=-2, thickness=-1
                    )

    return out, updated, instance_counter
