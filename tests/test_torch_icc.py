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


def _icc_args(rng, N=3, V=8):
    Ts = []
    for _ in range(N):
        T = np.eye(4)
        T[:3, 3] = rng.uniform(-0.02, 0.02, 3)
        Ts.append(T)
    pts = [rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
           for n in (40, 64, 90)[:N]]
    sdf = [rng.uniform(0, 0.01, len(p)).astype(np.float32) for p in pts]
    pitch = [0.01, 0.011, 0.009][:N]
    origin = [rng.uniform(-0.05, -0.03, 3) for _ in range(N)]
    gt = (rng.rand(N, V, V, V) * 255).astype(np.uint8)
    gn = (rng.rand(N, V, V, V) * 255).astype(np.uint8)
    return (Ts, pts, sdf, pitch, origin, gt, gn), dict(voxel_dim=V,
                                                       max_points=64)


def test_refine_async_then_resolve_equals_refine(rng):
    args, kw = _icc_args(rng)
    a = TC.IterativeCollisionCheck(*args, **kw, device="cpu")
    a.refine_async(iterations=6)
    got = a.resolve()
    want = TC.IterativeCollisionCheck(*args, **kw, device="cpu").refine(
        iterations=6)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    # a second refine starts from the first one's result, as in JAX
    j = JC.IterativeCollisionCheck(*args, **kw)
    j.refine(iterations=6)
    np.testing.assert_allclose(a.refine(iterations=3)[0],
                               j.refine(iterations=3)[0], atol=1e-4)


@pytest.mark.parametrize("early_stop", [True, False])
def test_refine_collision_early_stop_against_jax(rng, early_stop):
    """alpha=0.001 plateaus as soon as the rule can fire (its 10 loss
    changes need 11 losses): with early_stop the parameters freeze there,
    without it all 16 iterations update them."""
    q, t, arrays = _case(rng)
    kw = dict(voxel_dim=16, threshold=2.0, iterations=16, alpha=0.001,
              early_stop=early_stop)
    jq, jt, jl, jn = JC.refine_collision(
        jnp.asarray(q), jnp.asarray(t), *map(jnp.asarray, arrays), **kw)
    tq, tt, tl, tn = TC.refine_collision(
        torch.from_numpy(q), torch.from_numpy(t),
        *map(torch.from_numpy, arrays), **kw)
    assert int(tn) == int(jn)
    assert (int(tn) < 16) == early_stop
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5)
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-4)


def test_warmup_buckets_runs():
    TC.IterativeCollisionCheck.warmup_buckets((1, 3), voxel_dim=8,
                                              max_points=16, iterations=2,
                                              device="cpu")


def test_masked_adam_matches_optax_with_freeze(rng):
    """The loop's Adam against optax on the same gradients, with the
    refiner's two groups (quaternions at 0.01, translations at 0.001) packed
    into one state as the loop packs them. From step 12 on the state is
    frozen as the loop freezes it once the plateau rule fires (step k's
    bias correction, whose step is discarded), and optax's state is simply
    not updated."""
    q0 = rng.normal(size=(2, 4)).astype(np.float32)
    t0 = rng.normal(size=(2, 3)).astype(np.float32)
    grads = rng.normal(size=(20, 2, 7)).astype(np.float32)
    tx = optax.multi_transform(
        {"q": optax.adam(0.01), "t": optax.adam(0.001)},
        {"quaternion": "q", "translation": "t"})
    params = dict(quaternion=jnp.asarray(q0), translation=jnp.asarray(t0))
    opt_state = tx.init(params)
    decay, one_minus_decay, bias = TC._adam_constants(20, "cpu")
    neg_lr = torch.full((2, 7), -0.01)
    neg_lr[:, 4:] = -0.001
    p0 = torch.from_numpy(np.concatenate([q0, t0], 1))
    state = torch.cat([p0[None], torch.zeros((2, 2, 7))])
    for k, g in enumerate(grads):
        stopped = torch.tensor(k >= 12)
        if k < 12:
            upd, opt_state = tx.update(
                dict(quaternion=jnp.asarray(g[:, :4]),
                     translation=jnp.asarray(g[:, 4:])), opt_state, params)
            params = optax.apply_updates(params, upd)
        new = TC._adam_step(state, torch.from_numpy(g), decay,
                            one_minus_decay, bias[k], neg_lr)
        state = torch.where(stopped, state, new)
    for group, cols in (("q", slice(0, 4)), ("t", slice(4, 7))):
        adam = opt_state.inner_states[group].inner_state[0]
        assert int(adam.count) == 12
        name = "quaternion" if group == "q" else "translation"
        np.testing.assert_allclose(state[0, :, cols].numpy(), params[name],
                                   atol=1e-6)
        np.testing.assert_allclose(state[1, :, cols].numpy(),
                                   adam.mu[name], atol=1e-7)
        np.testing.assert_allclose(state[2, :, cols].numpy(),
                                   adam.nu[name], atol=1e-7)


def test_refine_async_reads_nothing_to_the_host(rng, monkeypatch):
    """Between refine_async and resolve nothing is read to the host: every
    way a tensor reaches a Python value, and boolean-mask indexing and
    nonzero (whose output shape needs the data), raises while the loop is
    enqueued. Only resolve reads. A tensor made from Python data raises
    too: on the card that is an upload, which synchronises the stream."""
    args, kw = _icc_args(rng)
    icc = TC.IterativeCollisionCheck(*args, **kw, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("host read inside the ICC loop")

    getitem = torch.Tensor.__getitem__

    def no_mask_index(self, idx):
        parts = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in parts):
            refuse()
        return getitem(self, idx)

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "nonzero", "__bool__",
                     "__float__", "__int__", "__index__"):
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch, "nonzero", refuse)
        m.setattr(torch, "tensor", refuse)
        as_tensor = torch.as_tensor
        m.setattr(torch, "as_tensor", lambda x, *a, **k: (
            as_tensor(x, *a, **k) if isinstance(x, torch.Tensor)
            else refuse()))
        m.setattr(torch, "masked_select", refuse)
        m.setattr(torch.Tensor, "__getitem__", no_mask_index)
        icc.refine_async(iterations=12)
    T, losses, n_iter = icc.resolve()
    assert T.shape == (3, 4, 4) and losses.shape == (12,)
    assert 0 < n_iter <= 12
