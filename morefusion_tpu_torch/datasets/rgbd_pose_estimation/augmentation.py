"""Training-time augmentations on the host (cv2 and NumPy).

Own copy of ``morefusion_tpu/datasets/rgbd_pose_estimation/
augmentation.py`` (``augment_rgb``, ``augment_pcd``, ``augment_mask``,
``augment_mask_z``, ``augment_rgbd``): RGB contrast / HSV / Gaussian blur /
resolution degradation; PCD dropout + Gaussian noise; mask truncation
(random bbox shifts + contour selection), also of the transfer form's depth
and affine coefficients. cv2 is imported inside each function.
"""

from __future__ import annotations

import numpy as np

from ...extra.image import centerize
from ...geometry.bbox import masks_to_bboxes


def augment_rgb(rgb: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    import cv2

    out = rgb.astype(np.float32)

    # linear contrast (iaa.LinearContrast alpha 0.8-1.2)
    alpha = rng.uniform(0.8, 1.2)
    out = (out - 127.0) * alpha + 127.0
    out = np.clip(out, 0, 255).astype(np.uint8)

    # HSV jitter: S,V x(0.8-1.2) per channel; H x(0.95-1.05)
    hsv = cv2.cvtColor(out, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[..., 0] *= rng.uniform(0.95, 1.05)
    hsv[..., 1] *= rng.uniform(0.8, 1.2)
    hsv[..., 2] *= rng.uniform(0.8, 1.2)
    hsv[..., 0] = np.mod(hsv[..., 0], 180)
    hsv = np.clip(hsv, 0, [180, 255, 255]).astype(np.uint8)
    out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)

    # gaussian blur sigma 0-1
    sigma = rng.uniform(0, 1.0)
    if sigma > 0.1:
        out = cv2.GaussianBlur(out, (0, 0), sigma)

    # resolution degradation (resize 0.25-1.0 and back)
    scale = rng.uniform(0.25, 1.0)
    if scale < 0.99:
        H, W = out.shape[:2]
        small = cv2.resize(
            out,
            (max(1, int(W * scale)), max(1, int(H * scale))),
            interpolation=cv2.INTER_LINEAR,
        )
        out = cv2.resize(small, (W, H), interpolation=cv2.INTER_LINEAR)
    return out


def augment_pcd(pcd: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    out = pcd.copy()
    dropout = rng.binomial(1, 0.05, size=out.shape[:2]).astype(bool)
    out[dropout] = np.nan
    out = out + rng.normal(0, 0.003, size=out.shape).astype(out.dtype)
    return out


def _truncate_mask(mask, rng: np.random.RandomState):
    """The mask-truncation draw: bbox-edge shift + contour subset, on a
    copy of ``mask``."""
    import cv2

    mask = mask.copy()
    H, W = mask.shape
    case = rng.choice(4)
    y1, x1, y2, x2 = masks_to_bboxes(mask[None])[0]
    if case == 0:
        y1 = rng.uniform(0, (y2 - y1) * 0.25)
    elif case == 1:
        y2 = H - rng.uniform(0, (y2 - y1) * 0.25)
    elif case == 2:
        x1 = rng.uniform(0, (x2 - x1) * 0.25)
    else:
        x2 = W - rng.uniform(0, (x2 - x1) * 0.25)
    y1, x1, y2, x2 = np.array([y1, x1, y2, x2]).round().astype(int)
    mask[:y1, :] = 0
    mask[y2:, :] = 0
    mask[:, :x1] = 0
    mask[:, x2:] = 0

    contours, _ = cv2.findContours(
        mask.astype(np.uint8),
        mode=cv2.RETR_TREE,
        method=cv2.CHAIN_APPROX_SIMPLE,
    )
    if contours:
        areas = [cv2.contourArea(c) for c in contours]
        mask_contour = np.zeros((H, W), dtype=np.uint8)
        cv2.drawContours(
            mask_contour, contours, int(np.argmax(areas)), color=1,
            thickness=-1,
        )
        n_extra = rng.choice(len(contours))
        for ci in rng.permutation(len(contours))[:n_extra]:
            cv2.drawContours(
                mask_contour, contours, int(ci), color=1, thickness=-1
            )
        mask = mask_contour.astype(bool)
    return mask


def augment_mask(rgb, pcd, rng: np.random.RandomState):
    """Random mask truncation: bbox-edge shift + contour subset selection."""
    H, W = rgb.shape[:2]
    mask = ~np.isnan(pcd).any(axis=2)
    orig_count = mask.sum()
    if orig_count == 0:
        return rgb, pcd
    new_mask = _truncate_mask(mask, rng)
    # never truncate a small mask to (near-)nothing: the point sampler
    # needs a usable pixel population
    if new_mask.sum() < max(64, 0.05 * orig_count):
        return rgb, pcd
    mask = new_mask

    rgb = rgb.copy()
    pcd = pcd.copy()
    rgb[~mask] = 0
    pcd[~mask] = np.nan

    if not mask.any():
        return rgb, pcd
    bbox = masks_to_bboxes(mask[None])[0]
    y1, x1, y2, x2 = bbox.round().astype(int)
    if (y2 - y1) * (x2 - x1) == 0:
        return rgb, pcd
    rgb = centerize(rgb[y1:y2, x1:x2], (H, W))
    pcd = centerize(
        pcd[y1:y2, x1:x2], (H, W), cval=np.nan, interpolation="nearest"
    )
    return rgb, pcd


def augment_mask_z(rgb, z, coef, rng: np.random.RandomState):
    """``augment_mask`` for the transfer form: depth ``z`` (float16) and the
    affine coefficients of its cloud (``x = z (a + b j)``, ``y = z (c +
    d i)``, ``training/transfer.py``).

    The same truncation and recentring draw, applied to the depth image;
    the coefficients follow the recentring's remap analytically (output
    pixel j' samples source column j = x1 + (j' - x0) / s), so the cloud
    rebuilt on the device matches the augmented crop.
    """
    H, W = z.shape
    z_dtype = z.dtype
    mask = np.isfinite(z)
    orig_count = mask.sum()
    if orig_count == 0:
        return rgb, z, coef
    new_mask = _truncate_mask(mask, rng)
    if new_mask.sum() < max(64, 0.05 * orig_count):
        return rgb, z, coef
    mask = new_mask

    rgb = rgb.copy()
    z = z.astype(np.float32)  # cv2 has no float16 path
    rgb[~mask] = 0
    z[~mask] = np.nan

    if not mask.any():
        return rgb, z.astype(z_dtype), coef
    bbox = masks_to_bboxes(mask[None])[0]
    y1, x1, y2, x2 = bbox.round().astype(int)
    ch, cw = y2 - y1, x2 - x1
    if ch * cw == 0:
        return rgb, z.astype(z_dtype), coef
    rgb = centerize(rgb[y1:y2, x1:x2], (H, W))
    z = centerize(
        z[y1:y2, x1:x2], (H, W), cval=np.nan, interpolation="nearest"
    )
    # centerize's placement (extra/image.py)
    s = min(H / ch, W / cw)
    h, w = max(1, int(round(ch * s))), max(1, int(round(cw * s)))
    y0, x0 = (H - h) // 2, (W - w) // 2
    sw, sh = w / cw, h / ch  # the per-axis scales after rounding
    a, b, c, d = [float(v) for v in coef]
    coef = np.array(
        [a + b * (x1 - x0 / sw), b / sw, c + d * (y1 - y0 / sh), d / sh],
        np.float32,
    )
    return rgb, z.astype(z_dtype), coef


def augment_rgbd(rgb, pcd, rng: np.random.RandomState):
    rgb, pcd = augment_mask(rgb, pcd, rng)
    rgb = augment_rgb(rgb, rng)
    pcd = augment_pcd(pcd, rng)
    return rgb, pcd
