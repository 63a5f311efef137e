"""Bounding boxes of instance masks.

Own copy of ``morefusion_tpu/geometry/bbox.py::masks_to_bboxes``.
"""

from __future__ import annotations

import numpy as np


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
