"""The port's device augmentation against ``morefusion_tpu.training.
augment_device`` on the CPU.

The apply half of each augmentation runs on the same images and the same
parameters as JAX's functions; JAX's whole ``augment_rgb_device`` and
``augment_pcd_device`` run with their ``jax.random`` draws replaced by the
port's parameters. Tolerance: 1e-5 absolute on images in [0, 1] (and 255
times that on the [0, 255] output of the whole rgb augmentation): float32
on both sides, sums in other orders (the blur's taps; the port applies the
resize down and back up along an axis as one matrix where JAX applies two).
Colour conversions and the point cloud's noise agree exactly.

The draw half comes from torch generators, not ``jax.random``: its ranges
are checked, with the point cloud's drop share within 5% +- 1% and its
noise's standard deviation within 3 mm +- 10%.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu.training import augment_device as JA
from morefusion_tpu_torch.training import augment_device as TA

torch.set_num_threads(2)

ATOL = 1e-5  # on [0, 1] images

# JAX's references compiled once a scale (eager dispatch of the resize
# costs seconds)
_J_DEGRADE_ONE = jax.jit(JA._degrade_one, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _images(rng, B=2, H=40, W=56):
    x = rng.rand(B, H, W, 3).astype(np.float32)
    x[:, :4] = 0.5  # grey: zero saturation, no hue
    x[:, 4:8, :, 0] = x[:, 4:8, :, 1]  # ties of the max channel
    x[:, 8:10] = 0.0  # black
    return x


def test_rgb_to_hsv_matches_jax(rng):
    x = _images(rng)
    _close(TA.rgb_to_hsv(_t(x)), JA.rgb_to_hsv(x), atol=0)


def test_hsv_to_rgb_matches_jax_on_any_hue(rng):
    """Hues below 0 and at and above 1: floor-mod in both, and
    ``jnp.choose``'s clipping of the sector index."""
    hsv = rng.rand(500, 3).astype(np.float32)
    hsv[:, 0] = rng.uniform(-2.5, 2.5, 500).astype(np.float32)
    hsv[:5, 0] = [-1.0, 0.0, 1.0, 1.0 - 1e-8, 7.0 / 6.0]
    _close(TA.hsv_to_rgb(_t(hsv)), JA.hsv_to_rgb(hsv), atol=0)


def test_hue_round_trip_with_negative_factor_products(rng):
    """``(h * f) % 1.0`` of the jitter on a negative hue product."""
    h = _t(rng.uniform(-1, 1, 300).astype(np.float32))
    got = torch.remainder(h * 1.03, 1.0)
    want = (jnp.asarray(h.numpy()) * jnp.float32(1.03)) % 1.0
    _close(got, want, atol=0)
    assert (got >= 0).all() and (got <= 1).all()


@pytest.mark.parametrize("sigma", [1e-3, 0.05, 0.3, 0.77, 1.0])
def test_gauss_kernel_matches_jax(sigma):
    _close(TA._gauss_kernel(torch.tensor(sigma, dtype=torch.float32)),
           JA._gauss_kernel(jnp.float32(sigma)))


@pytest.mark.parametrize("sigma", [1e-3, 0.15, 0.5, 1.0])
def test_blur_one_matches_jax(rng, sigma):
    img = _images(rng, B=1)[0]
    got = TA._blur_one(_t(img), torch.tensor(sigma, dtype=torch.float32))
    _close(got, JA._blur_one(img, jnp.float32(sigma)))


def test_blur_edge_pads_before_the_valid_convolution():
    """A constant image stays constant up to its borders (zero padding
    would darken them)."""
    img = torch.full((12, 9, 3), 0.7)
    out = TA._blur_one(img, torch.tensor(1.0))
    torch.testing.assert_close(out, img, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale_idx", range(len(TA.SCALES)))
def test_degrade_one_matches_jax(rng, scale_idx):
    """Each scale at the train crop's size, 256 x 256."""
    img = rng.rand(256, 256, 3).astype(np.float32)
    got = TA._degrade_one(_t(img), scale_idx)
    _close(got, _J_DEGRADE_ONE(img, scale_idx))
    if TA.SCALES[scale_idx] == 1.0:
        assert torch.equal(got, _t(img))


def test_degrade_batch_mixes_scales(rng):
    img = rng.rand(3, 32, 24, 3).astype(np.float32)
    idx = torch.tensor([0, 4, 2])
    got = TA._degrade(_t(img), idx)
    for b in range(3):
        _close(got[b], _J_DEGRADE_ONE(img[b], int(idx[b])))


def _patched_draws(values):
    """``jax.random.uniform`` / ``randint`` / ``bernoulli`` / ``normal``
    returning ``values`` in call order, shaped as asked (the first tuple
    among the arguments)."""
    queue = list(values)

    def draw(key, *args, **kw):
        shape = next(a for a in args if isinstance(a, tuple))
        return jnp.asarray(np.asarray(queue.pop(0)).reshape(shape))

    return draw


def test_augment_rgb_matches_jax_at_the_same_parameters(rng):
    rgb = rng.randint(0, 256, (4, 48, 64, 3)).astype(np.uint8)
    params = TA.draw_rgb_params(torch.Generator().manual_seed(5), 4, "cpu")
    params["scale_idx"] = torch.tensor([0, 1, 3, 4])
    params["sigma"][0] = 1e-3  # the delta kernel
    got = TA.apply_rgb(_t(rgb), params)
    uniform = [params[k].numpy() for k in ("alpha", "fh", "fs", "fv",
                                           "sigma")]
    with mock.patch.object(JA.jax.random, "uniform",
                           _patched_draws(uniform)), \
            mock.patch.object(JA.jax.random, "randint", _patched_draws(
                [params["scale_idx"].numpy()])):
        # traced inside the patch, so the patched draws are its inputs
        want = jax.jit(JA.augment_rgb_device)(jax.random.PRNGKey(0), rgb)
    assert got.dtype == torch.float32 and got.shape == rgb.shape
    _close(got, want, atol=255 * ATOL)


def test_augment_pcd_matches_jax_at_the_same_parameters(rng):
    pcd = rng.uniform(-0.1, 0.1, (2, 30, 40, 3)).astype(np.float32)
    pcd[:, :3] = np.nan
    params = TA.draw_pcd_params(torch.Generator().manual_seed(2), pcd.shape,
                                "cpu")
    got = TA.apply_pcd(_t(pcd), params)
    with mock.patch.object(JA.jax.random, "bernoulli", _patched_draws(
            [params["drop"].numpy()])), \
            mock.patch.object(JA.jax.random, "normal", _patched_draws(
                [params["z"].numpy()])):
        want = JA.augment_pcd_device(jax.random.PRNGKey(0), pcd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pcd_draw_ranges():
    shape = (4, 128, 128, 3)
    params = TA.draw_pcd_params(torch.Generator().manual_seed(0), shape,
                                "cpu")
    share = float(params["drop"].float().mean())
    assert abs(share - 0.05) <= 0.01, share
    noise = TA.apply_pcd(torch.zeros(shape), params)
    std = float(noise[~params["drop"]].std())
    assert abs(std - 0.003) <= 0.0003, std


def test_rgb_draw_ranges():
    p = TA.draw_rgb_params(torch.Generator().manual_seed(0), 4000, "cpu")
    for k, lo, hi in (("alpha", 0.8, 1.2), ("fh", 0.95, 1.05),
                      ("fs", 0.8, 1.2), ("fv", 0.8, 1.2)):
        assert lo <= float(p[k].min()) and float(p[k].max()) <= hi, k
        assert float(p[k].max()) - float(p[k].min()) > 0.9 * (hi - lo), k
    sigma = p["sigma"]
    assert ((sigma == 1e-3) | ((sigma >= 0.1) & (sigma <= 1.0))).all()
    assert abs(float((sigma == 1e-3).float().mean()) - 0.1) < 0.03
    assert sorted(p["scale_idx"].unique().tolist()) == [0, 1, 2, 3, 4]


def test_augment_batch_follows_its_generator(rng):
    rgb = _t(rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8))
    pcd = _t(rng.uniform(-0.1, 0.1, (2, 32, 32, 3)).astype(np.float32))
    a = TA.augment_batch(torch.Generator().manual_seed(1), rgb, pcd)
    b = TA.augment_batch(torch.Generator().manual_seed(1), rgb, pcd)
    c = TA.augment_batch(torch.Generator().manual_seed(2), rgb, pcd)
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].nan_to_num(7.0), b[1].nan_to_num(7.0))
    assert not torch.equal(a[0], c[0])
    assert float(a[0].min()) >= 0 and float(a[0].max()) <= 255
