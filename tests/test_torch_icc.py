"""The port's ICC refiner against ``morefusion_tpu.contrib.collision_refine``.

Same float32 inputs from a seed through both packages on the CPU. The loss
agrees to ~1e-6 (grids differ by float32 rounding of the distance field,
see test_torch_functions.py), its gradients to 1e-3 of their largest entry
(that rounding enters through 1/d at voxels next to a point); after 10
Adam steps the poses agree to 1e-4 and the losses to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morefusion_tpu.contrib import collision_refine as JC
from morefusion_tpu_torch.contrib import collision_refine as TC

torch.set_num_threads(2)


def _case(rng, N=3, M=128, V=16):
    pts = rng.uniform(-0.04, 0.04, (N, M, 3)).astype(np.float32)
    sdf = rng.uniform(0, 0.02, (N, M)).astype(np.float32)
    mask = np.ones((N, M), bool)
    mask[-1, M // 2:] = False
    pitch = rng.uniform(0.008, 0.012, N).astype(np.float32)
    origin = rng.uniform(-0.1, -0.06, (N, 3)).astype(np.float32)
    gt = rng.rand(N, V, V, V).astype(np.float32)
    gn = rng.rand(N, V, V, V).astype(np.float32)
    q = (np.tile(np.array([1, 0, 0, 0], np.float32), (N, 1))
         + rng.normal(0, 0.05, (N, 4)).astype(np.float32))
    t = rng.uniform(-0.02, 0.02, (N, 3)).astype(np.float32)
    return q, t, [pts, sdf, mask, pitch, origin, gt, gn]


@pytest.mark.parametrize("obj_mask", [(1, 1, 1), (1, 1, 0)])
def test_icc_loss_value_and_gradients(rng, obj_mask):
    q, t, arrays = _case(rng)
    om = np.array(obj_mask, bool)
    kw = dict(voxel_dim=16, threshold=2.0)
    jl, (jgq, jgt) = jax.jit(jax.value_and_grad(
        lambda q, t: JC.icc_loss(q, t, *map(jnp.asarray, arrays),
                                 jnp.asarray(om), **kw),
        argnums=(0, 1)))(jnp.asarray(q), jnp.asarray(t))
    tq = torch.tensor(q, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    loss = TC.icc_loss(tq, tt, *map(torch.from_numpy, arrays),
                       torch.from_numpy(om), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=1e-5)
    for got, want in ((tq.grad, jgq), (tt.grad, jgt)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-3 * np.abs(want).max())


def test_icc_loss_exact_mode_is_not_ported(rng):
    q, t, arrays = _case(rng, N=2, M=8, V=4)
    with pytest.raises(NotImplementedError):
        TC.icc_loss(torch.from_numpy(q), torch.from_numpy(t),
                    *map(torch.from_numpy, arrays), torch.ones(2, dtype=bool),
                    voxel_dim=4, cross_mode="exact")


@pytest.mark.parametrize("alpha,obj_mask", [(0.01, (1, 1, 0)),
                                            (0.001, (1, 1, 0)),
                                            (0.01, (1, 1, 1))])
def test_refine_collision_outputs(rng, alpha, obj_mask):
    """10 iterations at N=3, M=128, V=16, with and without a padded object
    slot; alpha=0.001 stops early, so its tail holds the loss at the frozen
    parameters."""
    q, t, arrays = _case(rng)
    om = np.array(obj_mask, bool)
    kw = dict(voxel_dim=16, threshold=2.0, iterations=10 if alpha > 0.005
              else 30, alpha=alpha)
    jq, jt, jl, jn = JC.refine_collision(
        jnp.asarray(q), jnp.asarray(t), *map(jnp.asarray, arrays),
        obj_mask=jnp.asarray(om), **kw)
    tq, tt, tl, tn = TC.refine_collision(
        torch.from_numpy(q), torch.from_numpy(t),
        *map(torch.from_numpy, arrays), obj_mask=torch.from_numpy(om), **kw)
    assert tn == int(jn)
    assert tl.shape == (kw["iterations"],)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5)
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-4)
    if tn < kw["iterations"]:
        assert np.all(tl.numpy()[tn + 1:] == tl.numpy()[tn])


def test_refine_collision_dequantizes_uint8_grids(rng):
    q, t, arrays = _case(rng, N=2, M=32, V=8)
    arrays[5] = (arrays[5] * 255).round().astype(np.uint8)
    arrays[6] = (arrays[6] * 255).round().astype(np.uint8)
    kw = dict(voxel_dim=8, iterations=3)
    jout = JC.refine_collision(jnp.asarray(q), jnp.asarray(t),
                               *map(jnp.asarray, arrays), **kw)
    tout = TC.refine_collision(torch.from_numpy(q), torch.from_numpy(t),
                               *map(torch.from_numpy, arrays), **kw)
    np.testing.assert_allclose(tout[2].numpy(), jout[2], atol=1e-5)


def test_torch_adam_matches_optax_adam(rng):
    """torch.optim.Adam and optax.adam (eps outside the square root,
    eps_root=0) take the same steps on the same gradients."""
    p0 = rng.normal(size=(5,)).astype(np.float32)
    grads = rng.normal(size=(20, 5)).astype(np.float32)
    tx = optax.adam(0.01)
    p, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.Adam([tp], lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), p, atol=1e-6)


def test_iterative_collision_check_pads_and_refines(rng):
    N, V = 3, 8
    Ts = []
    for _ in range(N):
        T = np.eye(4)
        T[:3, 3] = rng.uniform(-0.02, 0.02, 3)
        Ts.append(T)
    pts = [rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
           for n in (40, 64, 90)]
    sdf = [rng.uniform(0, 0.01, len(p)).astype(np.float32) for p in pts]
    pitch = [0.01, 0.011, 0.009]
    origin = [rng.uniform(-0.05, -0.03, 3) for _ in range(N)]
    gt = (rng.rand(N, V, V, V) * 255).astype(np.uint8)
    gn = (rng.rand(N, V, V, V) * 255).astype(np.uint8)
    args = (Ts, pts, sdf, pitch, origin, gt, gn)
    kw = dict(voxel_dim=V, max_points=64)
    j_T, j_l, j_n = JC.IterativeCollisionCheck(*args, **kw).refine(
        iterations=5)
    icc = TC.IterativeCollisionCheck(*args, **kw, device="cpu")
    assert icc._arrays["points"].shape == (4, 64, 3)  # N=3 pads to 4
    t_T, t_l, t_n = icc.refine(iterations=5)
    assert t_T.shape == (N, 4, 4) and t_n == j_n
    np.testing.assert_allclose(t_l, j_l, atol=1e-5)
    np.testing.assert_allclose(t_T, j_T, atol=1e-4)
