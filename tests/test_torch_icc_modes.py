"""ICC's exact cross mode, per-object parts, grid upsampling and rate decay,
the port against ``morefusion_tpu.contrib.collision_refine``.

Same float32 inputs from a seed through both packages on the CPU, held as
``test_torch_icc.py`` holds the resample mode: the loss within 1e-5, its
gradients within 1e-3 of their largest entry, and after 16 Adam steps the
poses within 1e-4 and the losses within 1e-5. The upsampled grids and the
rate schedule are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morefusion_tpu.contrib import collision_refine as JC
from morefusion_tpu_torch.contrib import collision_refine as TC
from tests.test_torch_icc import _case, _icc_args

torch.set_num_threads(2)

LOSS_ATOL, POSE_ATOL = 1e-5, 1e-4


@pytest.mark.parametrize("scale", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_upsample_observed_grid_bit_for_bit(rng, scale, dtype):
    grid = rng.rand(2, 5, 6, 7)
    grid = ((grid * 255).astype(np.uint8) if dtype == np.uint8
            else grid.astype(np.float32))
    got = TC.upsample_observed_grid(grid, scale)
    want = JC.upsample_observed_grid(grid, scale)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (2, 5 * scale, 6 * scale, 7 * scale)
    np.testing.assert_array_equal(got, want)
    # even fine indices land on the coarse centres
    np.testing.assert_array_equal(got[:, ::scale, ::scale, ::scale],
                                  grid.astype(np.float32))


def _exact_case(rng, V):
    """N = 3 with one padded slot, M = 64 (a third of the last object's
    points masked)."""
    q, t, arrays = _case(rng, N=3, M=64, V=V)
    return q, t, arrays, np.array([1, 1, 0], bool)


def _jax_loss(q, t, arrays, om, **kw):
    return jax.jit(jax.value_and_grad(
        lambda q, t: JC.icc_loss(q, t, *map(jnp.asarray, arrays),
                                 jnp.asarray(om), **kw),
        argnums=(0, 1)))(jnp.asarray(q), jnp.asarray(t))


def _torch_loss(q, t, arrays, om, **kw):
    tq = torch.tensor(q, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    loss = TC.icc_loss(tq, tt, *map(torch.from_numpy, arrays),
                       torch.from_numpy(om), **kw)
    loss.backward()
    return loss.detach(), tq.grad, tt.grad


@pytest.mark.parametrize("V", [8, 16])
def test_icc_loss_exact_mode_value_and_gradients(rng, V):
    """Exact mode with ``sdf_offset`` != 0: the offset enters the own grids
    and not the cross voxelization, in both packages."""
    q, t, arrays, om = _exact_case(rng, V)
    kw = dict(voxel_dim=V, threshold=2.0, sdf_offset=0.004,
              cross_mode="exact")
    jl, (jgq, jgt) = _jax_loss(q, t, arrays, om, **kw)
    loss, gq, gt = _torch_loss(q, t, arrays, om, **kw)
    np.testing.assert_allclose(float(loss), float(jl), atol=LOSS_ATOL)
    for got, want in ((gq, jgq), (gt, jgt)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-3 * np.abs(want).max())
    # the two modes are different objectives on these inputs
    other, _, _ = _torch_loss(q, t, arrays, om,
                              **dict(kw, cross_mode="resample"))
    assert abs(float(other) - float(loss)) > 1e-4


@pytest.mark.parametrize("cross_mode", ["resample", "exact"])
def test_icc_loss_return_parts(rng, cross_mode):
    q, t, arrays, om = _exact_case(rng, 8)
    kw = dict(voxel_dim=8, cross_mode=cross_mode, sdf_offset=0.002)
    jl, (jp, jr) = JC.icc_loss(
        jnp.asarray(q), jnp.asarray(t), *map(jnp.asarray, arrays),
        jnp.asarray(om), return_parts=True, **kw)
    targs = (torch.from_numpy(q), torch.from_numpy(t),
             *map(torch.from_numpy, arrays), torch.from_numpy(om))
    tl, (tp, tr) = TC.icc_loss(*targs, return_parts=True, **kw)
    assert float(tl) == float(TC.icc_loss(*targs, **kw))
    np.testing.assert_allclose(float(tl), float(jl), atol=LOSS_ATOL)
    np.testing.assert_allclose(tp.numpy(), jp, atol=LOSS_ATOL)
    np.testing.assert_allclose(tr.numpy(), jr, atol=LOSS_ATOL)
    assert tp[2] == 0 and tr[2] == 0  # the padded slot
    # the whole is the parts' ratio of sums, not their mean: both nonzero
    assert float(tp[:2].min()) > 0 and float(tr[:2].min()) > 0


@pytest.mark.parametrize("iterations", [16, 30])
def test_neg_rates_match_optax_cosine_decay(iterations):
    """Step k's rate is the optax schedule at count k, as ``tx.update``
    evaluates it inside the jitted refine, cast to float32."""
    alpha = 0.01
    got = TC._neg_rates(iterations, 2, alpha, True, "cpu")
    assert got.shape == (iterations, 2, 7) and got.dtype == torch.float32
    for init, cols in ((alpha, slice(0, 4)), (alpha * 0.1, slice(4, 7))):
        schedule = jax.jit(optax.cosine_decay_schedule(init, iterations))
        want = np.array([
            np.asarray(-schedule(jnp.asarray(k, jnp.int32)), np.float32)
            for k in range(iterations)])
        np.testing.assert_array_equal(got[:, 0, cols].numpy(),
                                      np.repeat(want[:, None], cols.stop
                                                - cols.start, 1))
    flat = TC._neg_rates(iterations, 2, alpha, False, "cpu")
    assert bool((flat[..., :4] == np.float32(-alpha)).all())
    assert bool((flat[..., 4:] == np.float32(-alpha * 0.1)).all())


@pytest.mark.parametrize("cross_mode", ["resample", "exact"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_refine_collision_alpha_decay_against_jax(rng, cross_mode,
                                                  early_stop):
    """16 iterations with the cosine-decayed rate; alpha=0.001 plateaus as
    soon as the rule can fire, so with early_stop the parameters freeze
    there."""
    q, t, arrays, om = _exact_case(rng, 16)
    kw = dict(voxel_dim=16, threshold=2.0, iterations=16, alpha=0.001,
              early_stop=early_stop, cross_mode=cross_mode,
              alpha_decay=True)
    jq, jt, jl, jn = JC.refine_collision(
        jnp.asarray(q), jnp.asarray(t), *map(jnp.asarray, arrays),
        obj_mask=jnp.asarray(om), **kw)
    tq, tt, tl, tn = TC.refine_collision(
        torch.from_numpy(q), torch.from_numpy(t),
        *map(torch.from_numpy, arrays), obj_mask=torch.from_numpy(om), **kw)
    assert int(tn) == int(jn)
    assert (int(tn) < 16) == early_stop
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOSS_ATOL)
    np.testing.assert_allclose(tq.numpy(), jq, atol=POSE_ATOL)
    np.testing.assert_allclose(tt.numpy(), jt, atol=POSE_ATOL)


def test_refine_collision_alpha_decay_moves_less(rng):
    """The decayed rate ends the same run closer to its start than the
    constant one: the step sizes shrink to 0."""
    q, t, arrays, om = _exact_case(rng, 8)
    out = {}
    for decay in (False, True):
        out[decay] = TC.refine_collision(
            torch.from_numpy(q), torch.from_numpy(t),
            *map(torch.from_numpy, arrays), obj_mask=torch.from_numpy(om),
            voxel_dim=8, iterations=12, early_stop=False, alpha_decay=decay)
    assert not np.array_equal(out[True][2].numpy(), out[False][2].numpy())
    np.testing.assert_array_equal(out[True][2][:2].numpy(),
                                  out[False][2][:2].numpy())


@pytest.mark.parametrize("cross_mode", ["resample", "exact"])
def test_loss_components_against_jax(rng, cross_mode):
    """At the current poses, at given poses (uint8 grids, dequantized as
    ``/ 255``) and after a refine."""
    args, kw = _icc_args(rng)
    kw = dict(kw, cross_mode=cross_mode, sdf_offset=0.001)
    j = JC.IterativeCollisionCheck(*args, **kw)
    t = TC.IterativeCollisionCheck(*args, **kw, device="cpu")
    moved = [T.copy() for T in args[0]]
    for T in moved:
        T[:3, 3] += 0.004
    for call in (lambda x: x.loss_components(),
                 lambda x: x.loss_components(moved),
                 lambda x: (x.refine(iterations=4), x.loss_components())[1]):
        jl, jp, jr = call(j)
        tl, tp, tr = call(t)
        assert isinstance(tl, float)
        assert tp.shape == tr.shape == (3,)  # the real objects of 4 slots
        np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL)
        np.testing.assert_allclose(tp, jp, atol=LOSS_ATOL)
        np.testing.assert_allclose(tr, jr, atol=LOSS_ATOL)


def test_refine_async_takes_alpha_decay(rng):
    args, kw = _icc_args(rng)
    a = TC.IterativeCollisionCheck(*args, **kw, device="cpu")
    a.refine_async(iterations=6, alpha_decay=True, early_stop=False)
    got = a.resolve()
    want = JC.IterativeCollisionCheck(*args, **kw).refine(
        iterations=6, alpha_decay=True, early_stop=False)
    np.testing.assert_allclose(got[0], want[0], atol=POSE_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=LOSS_ATOL)
    assert got[2] == want[2] == 6


def test_warmup_buckets_exact_mode():
    TC.IterativeCollisionCheck.warmup_buckets(
        (1, 3), voxel_dim=8, max_points=16, iterations=2,
        cross_mode="exact", device="cpu")
