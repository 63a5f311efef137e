"""Background compositing for synthetic segmentation frames.

Own copy of ``morefusion_tpu/datasets/background_composite.py``: the
background pixels of a rendered frame are replaced, so a segmenter does
not learn "black background = object boundary". Without an image
directory, procedural textures (gradients, blurred noise, checkers,
speckle) are drawn from the same ``RandomState`` sequence as the JAX
package's, so a seed gives the same backgrounds bit for bit; a directory
of photos is used instead when one is given.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _procedural_background(shape, rng) -> np.ndarray:
    H, W = shape
    kind = rng.randint(4)
    if kind == 0:  # smooth color gradient
        c0 = rng.randint(0, 255, 3).astype(np.float32)
        c1 = rng.randint(0, 255, 3).astype(np.float32)
        t = np.linspace(0, 1, W)[None, :, None]
        img = c0 * (1 - t) + c1 * t
        img = np.broadcast_to(img, (H, W, 3))
    elif kind == 1:  # low-frequency noise (blurred uniform)
        import cv2

        small = rng.randint(0, 255, (H // 8 + 1, W // 8 + 1, 3))
        img = cv2.resize(
            small.astype(np.uint8), (W, H), interpolation=cv2.INTER_CUBIC
        ).astype(np.float32)
    elif kind == 2:  # checker
        s = rng.randint(8, 40)
        yy, xx = np.meshgrid(np.arange(H) // s, np.arange(W) // s, indexing="ij")
        mask = ((yy + xx) % 2).astype(np.float32)[..., None]
        c0 = rng.randint(0, 255, 3).astype(np.float32)
        c1 = rng.randint(0, 255, 3).astype(np.float32)
        img = c0 * mask + c1 * (1 - mask)
    else:  # speckle
        img = rng.randint(0, 255, (H, W, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


class BackgroundComposite:
    """Replace background pixels of a rendered frame."""

    def __init__(
        self, image_dir: Optional[str] = None, seed: int = 0
    ):
        self._rng = np.random.RandomState(seed)
        self._files = []
        if image_dir and os.path.isdir(image_dir):
            self._files = [
                os.path.join(image_dir, f)
                for f in sorted(os.listdir(image_dir))
                if f.lower().endswith((".jpg", ".png", ".jpeg"))
            ]

    def _background(self, shape) -> np.ndarray:
        if self._files:
            import cv2
            import imageio.v2 as imageio

            f = self._files[self._rng.randint(len(self._files))]
            img = imageio.imread(f)[:, :, :3]
            return cv2.resize(img, (shape[1], shape[0]))
        return _procedural_background(shape, self._rng)

    def __call__(self, rgb: np.ndarray, instance_label: np.ndarray):
        bg = self._background(rgb.shape[:2])
        out = rgb.copy()
        mask = instance_label < 0
        out[mask] = bg[mask]
        return out
