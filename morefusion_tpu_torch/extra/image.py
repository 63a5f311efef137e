"""Image utilities: centerize (aspect-preserving resize + pad), resize.

Own copy of ``morefusion_tpu/extra/image.py``. cv2 is imported inside the
function that needs it.
"""

from __future__ import annotations

import numpy as np


def resize(img: np.ndarray, height: int, width: int, interpolation="linear"):
    import cv2

    interp = {
        "linear": cv2.INTER_LINEAR,
        "nearest": cv2.INTER_NEAREST,
    }[interpolation]
    return cv2.resize(img, (width, height), interpolation=interp)


def centerize(
    img: np.ndarray,
    shape,
    cval=0,
    interpolation: str = "linear",
) -> np.ndarray:
    """Resize keeping aspect ratio and pad to ``shape`` with ``cval``.

    NaN-safe for float images when ``interpolation='nearest'``.
    """
    H_dst, W_dst = shape
    H, W = img.shape[:2]
    scale = min(H_dst / H, W_dst / W)
    h, w = max(1, int(round(H * scale))), max(1, int(round(W * scale)))

    resized = resize(img, h, w, interpolation)
    if resized.ndim == img.ndim - 1:  # cv2 drops trailing singleton dims
        resized = resized[..., None]

    out_shape = (H_dst, W_dst) + img.shape[2:]
    out = np.full(out_shape, cval, dtype=img.dtype)
    y0 = (H_dst - h) // 2
    x0 = (W_dst - w) // 2
    out[y0 : y0 + h, x0 : x0 + w] = resized
    return out
