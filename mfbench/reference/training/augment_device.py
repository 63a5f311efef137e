"""Training augmentation on the device, inside the train step.

Port of ``morefusion_tpu/training/augment_device.py``: per-example linear
contrast, HSV jitter, Gaussian blur and resolution degradation of the RGB
crop; pixel dropout and Gaussian noise of the point cloud. The packed data
path leaves only the mask truncation to the host
(``datasets/packed.py``).

Each random function comes in two halves: ``draw_*`` draws the parameters
from a ``torch.Generator`` (the same distributions as JAX's, not its random
bits), and ``apply_*`` applies given parameters. The apply half is held to
JAX's functions at the same parameters.

- ``%`` on the hue is floor-mod in JAX: ``torch.remainder`` here;
- ``jnp.choose(..., mode="clip")`` clips the sector index to 0..5;
- ``jax.image.resize(method="linear")`` antialiases when it downscales:
  the resize here is the same pair of separable weight matrices as JAX's
  ``scale_and_translate`` (a triangle kernel widened by 1/scale when it
  downscales, the weights renormalized per output pixel), computed in
  float64; down and back up along an axis is their product, applied as
  one float32 matrix (JAX applies the two in turn);
- the blur edge-pads, then convolves in "valid" mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# the fixed scale set of the resolution degradation
SCALES = (0.25, 0.375, 0.5, 0.75, 1.0)
BLUR_RADIUS = 3
PCD_DROP_RATE = 0.05
PCD_NOISE_STD = 0.003  # m


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float in [0, 1] -> HSV with H in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(dim=-1).values
    minc = rgb.min(dim=-1).values
    v = maxc
    delta = maxc - minc
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    s = torch.where(maxc == 0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc),
                                        maxc))
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h),
                    torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6).clamp(0, 5).to(torch.int64)

    def choose(*options):
        return torch.gather(torch.stack(options, dim=-1), -1,
                            i[..., None])[..., 0]

    r = choose(v, q, p, p, t, v)
    g = choose(t, v, v, q, p, p)
    b = choose(p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


def _gauss_kernel(sigma: torch.Tensor, radius: int = BLUR_RADIUS):
    """(..., 2r+1) normalized Gaussians; a delta as sigma -> 0."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    sigma = torch.clamp(sigma, min=1e-3)[..., None]
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum(dim=-1, keepdim=True)


def _blur(img: torch.Tensor, sigma: torch.Tensor, radius: int = BLUR_RADIUS):
    """A separable Gaussian blur of each (H, W, C) image of ``img`` (B, H,
    W, C), with its own ``sigma`` (B,): edge padding, then a "valid" convolution along
    the rows, then the same along the columns."""
    B, H, W, C = img.shape
    k = _gauss_kernel(sigma, radius)  # (B, 2r+1)
    n = 2 * radius + 1
    x = torch.cat([img[:, :1].expand(B, radius, W, C), img,
                   img[:, -1:].expand(B, radius, W, C)], dim=1)
    x = sum(k[:, j, None, None, None] * x[:, j:j + H] for j in range(n))
    x = torch.cat([x[:, :, :1].expand(B, H, radius, C), x,
                   x[:, :, -1:].expand(B, H, radius, C)], dim=2)
    return sum(k[:, j, None, None, None] * x[:, :, j:j + W]
               for j in range(n))


@functools.lru_cache(maxsize=None)
def _resize_weights_np(input_size: int, output_size: int) -> np.ndarray:
    """(input_size, output_size) weights of JAX's ``scale_and_translate``
    with the triangle kernel and antialiasing, in float64."""
    scale = output_size / input_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(output_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(input_size)[:, None]) \
        / kernel_scale
    weights = np.maximum(0.0, 1.0 - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, 0.0)


@functools.lru_cache(maxsize=None)
def _degrade_matrices_np(size: int) -> np.ndarray:
    """(len(SCALES), size, size): down to each scale and back along one
    axis as one matrix, the product of the two resize weights."""
    mats = []
    for s in SCALES:
        n = max(1, int(size * s))
        if n == size:
            mats.append(np.eye(size))
        else:
            mats.append(_resize_weights_np(size, n)
                        @ _resize_weights_np(n, size))
    return np.stack(mats)


@functools.lru_cache(maxsize=None)
def _degrade_matrices(size, device):
    return torch.from_numpy(
        _degrade_matrices_np(size).astype(np.float32)).to(device)


def _degrade(img: torch.Tensor, scale_idx: torch.Tensor) -> torch.Tensor:
    """Each image of ``img`` (B, H, W, 3) down to ``SCALES`` at its own
    index and back, with no read to the host: each example's row and column
    matrices are gathered by its index."""
    H, W = img.shape[1:3]
    idx = scale_idx.to(img.device)
    mh = _degrade_matrices(H, img.device)[idx]  # (B, H, H)
    mw = _degrade_matrices(W, img.device)[idx]  # (B, W, W)
    x = torch.einsum("bhwc,bhk->bkwc", img, mh)
    return torch.einsum("bhwc,bwk->bhkc", x, mw)


def draw_rgb_params(generator: torch.Generator, B: int, device) -> dict:
    """Per-example contrast ``alpha``, HSV factors ``fh`` / ``fs`` /
    ``fv``, blur ``sigma`` and degradation ``scale_idx``."""

    def uniform(lo, hi):
        u = torch.rand(B, generator=generator, device=device)
        return lo + (hi - lo) * u

    params = dict(alpha=uniform(0.8, 1.2), fh=uniform(0.95, 1.05),
                  fs=uniform(0.8, 1.2), fv=uniform(0.8, 1.2),
                  sigma=uniform(0.0, 1.0))
    params["sigma"] = torch.where(params["sigma"] < 0.1,
                                  torch.full_like(params["sigma"], 1e-3),
                                  params["sigma"])
    params["scale_idx"] = torch.randint(0, len(SCALES), (B,),
                                        generator=generator, device=device)
    return params


def apply_rgb(rgb: torch.Tensor, params: dict) -> torch.Tensor:
    """``(B, H, W, 3)`` uint8-range -> float32 in [0, 255]: contrast, HSV
    jitter, blur and degradation at ``params`` (``draw_rgb_params``)."""
    x = rgb.to(torch.float32) / 255.0
    a = params["alpha"][:, None, None, None]
    x = torch.clamp((x - 0.5) * a + 0.5, 0.0, 1.0)

    hsv = rgb_to_hsv(x)
    hsv = torch.stack([
        torch.remainder(hsv[..., 0] * params["fh"][:, None, None], 1.0),
        torch.clamp(hsv[..., 1] * params["fs"][:, None, None], 0.0, 1.0),
        torch.clamp(hsv[..., 2] * params["fv"][:, None, None], 0.0, 1.0),
    ], dim=-1)
    x = hsv_to_rgb(hsv)
    x = _blur(x, params["sigma"])
    x = _degrade(x, params["scale_idx"])
    return torch.clamp(x, 0.0, 1.0) * 255.0


def draw_pcd_params(generator: torch.Generator, shape, device) -> dict:
    """The dropped pixels ``drop`` (B, H, W) and standard normal draws
    ``z`` (B, H, W, 3), which ``apply_pcd`` scales to the noise."""
    drop = torch.rand(shape[:3], generator=generator,
                      device=device) < PCD_DROP_RATE
    z = torch.randn(shape, generator=generator, device=device)
    return dict(drop=drop, z=z)


def apply_pcd(pcd: torch.Tensor, params: dict) -> torch.Tensor:
    out = pcd + PCD_NOISE_STD * params["z"]
    return torch.where(params["drop"][..., None],
                       torch.full_like(out, float("nan")), out)


def augment_rgb_device(generator, rgb):
    return apply_rgb(rgb, draw_rgb_params(generator, rgb.shape[0],
                                          rgb.device))


def augment_pcd_device(generator, pcd):
    return apply_pcd(pcd, draw_pcd_params(generator, pcd.shape, pcd.device))


def augment_batch(generator, rgb, pcd):
    return (augment_rgb_device(generator, rgb),
            augment_pcd_device(generator, pcd))
