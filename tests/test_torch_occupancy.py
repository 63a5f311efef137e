"""The port's soft occupancy grids against ``morefusion_tpu.functions``.

The same float32 inputs, made from a numpy seed, go through JAX's
``occupancy_grid_1d/2d/3d`` (dense XLA on the CPU) and the port's (the 3-D
grid through the min-distance op's plain version on the CPU). Values are
held within 1e-6, the gradients of a seeded weighted sum within 1e-5
relative to their largest entry. The points are continuous random draws, so
that no voxel has two nearest points (JAX splits a tie's gradient, the port
gives it to the lowest index) and no voxel centre lies on a point (JAX's
gradient is NaN there, the port's finite).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu import functions as JF
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu_torch import functions as TF
from morefusion_tpu_torch.functions import occupancy as TO

torch.set_num_threads(2)

VALUE_ATOL = 1e-6
GRAD_RTOL = 1e-5


def _cases():
    """``(name, points, kwargs)`` at the JAX tests' shapes and at 24^3 x
    800 CAD points of class 21."""
    rng = np.random.RandomState(0)
    cad = JModels().get_pcd(21)[:800].astype(np.float32)
    return [
        ("reference_example",
         np.array([[0, 0.05, 0.1], [3.9, 3.95, 4]], np.float32),
         dict(pitch=1.0, origin=(0.0, 0.0, 0.0), dims=(5, 5, 5),
              threshold=1)),
        ("dense", rng.uniform(0, 4, (7, 3)).astype(np.float32),
         dict(pitch=0.8, origin=(-0.2, 0.1, 0.0), dims=(5, 6, 4),
              threshold=2)),
        ("grads", rng.uniform(0.5, 3.5, (4, 3)).astype(np.float32),
         dict(pitch=1.0, origin=(0.0, 0.0, 0.0), dims=(5, 5, 5),
              threshold=1.5)),
        ("cad_24", cad,
         dict(pitch=0.01, origin=(-0.12, -0.12, -0.12), dims=(24, 24, 24),
              threshold=2.0)),
    ]


CASES = _cases()


def _jax_3d(points, kw):
    origin = np.asarray(kw["origin"], np.float32)
    return JF.occupancy_grid_3d(jnp.asarray(points), **dict(kw,
                                                            origin=origin))


def _torch_3d(points, kw):
    return TF.occupancy_grid_3d(points, **kw)


@pytest.mark.parametrize("name,points,kw", CASES, ids=[c[0] for c in CASES])
def test_occupancy_grid_3d_matches_jax(name, points, kw):
    want = np.asarray(_jax_3d(points, kw))
    got = _torch_3d(torch.from_numpy(points), kw).numpy()
    assert got.shape == want.shape == tuple(kw["dims"])
    np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=0)


@pytest.mark.parametrize("name,points,kw", CASES[1:],
                         ids=[c[0] for c in CASES[1:]])
def test_occupancy_grid_3d_grads_match_jax(name, points, kw):
    w = np.random.RandomState(1).rand(*kw["dims"]).astype(np.float32)
    g_want = np.asarray(jax.grad(
        lambda p: jnp.sum(_jax_3d(p, kw) * w))(jnp.asarray(points)))
    p = torch.from_numpy(points).requires_grad_(True)
    (torch.sum(_torch_3d(p, kw) * torch.from_numpy(w))).backward()
    assert np.isfinite(g_want).all()
    scale = np.abs(g_want).max()
    np.testing.assert_allclose(p.grad.numpy(), g_want,
                               atol=GRAD_RTOL * scale, rtol=0)


def test_occupancy_grid_3d_nan_point_gives_nan_grid():
    """One NaN point: JAX's ``jnp.min`` makes every voxel NaN; so does the
    port (a device-side flag, not the min-distance op, which drops it)."""
    points = np.random.RandomState(2).uniform(0, 4, (6, 3)).astype(
        np.float32)
    points[3, 1] = np.nan
    kw = dict(pitch=0.8, origin=(-0.2, 0.1, 0.0), dims=(5, 6, 4),
              threshold=2)
    want = np.asarray(_jax_3d(points, kw))
    got = _torch_3d(torch.from_numpy(points), kw).numpy()
    assert np.isnan(want).all()
    assert np.isnan(got).all()


def test_occupancy_grid_3d_equals_dense_torch_formula():
    """On the CPU the op equals the dense ``(X, Y, Z, P)`` formula in
    torch (both sum the squares in the same order)."""
    points = torch.from_numpy(
        np.random.RandomState(3).uniform(-0.1, 0.1, (300, 3)).astype(
            np.float32))
    pitch, origin, dims, threshold = 0.01, (-0.08, -0.08, -0.08), (16,) * 3, 2
    got = TF.occupancy_grid_3d(points, pitch=pitch, origin=origin,
                               dims=dims, threshold=threshold)
    ip = (points - torch.tensor(origin)) / pitch
    c = [torch.arange(n, dtype=torch.float32) for n in dims]
    dx = c[0][:, None, None, None] - ip[:, 0]
    dy = c[1][None, :, None, None] - ip[:, 1]
    dz = c[2][None, None, :, None] - ip[:, 2]
    d = torch.sqrt(dx**2 + dy**2 + dz**2).amin(dim=-1)
    want = torch.clamp(threshold - d, 0, 1)
    assert torch.equal(got, want)


def test_occupancy_grid_1d_matches_jax():
    rng = np.random.RandomState(4)
    for points, kw in [
        (np.array([0.05, 3.9], np.float32),
         dict(pitch=1.0, origin=0.0, dims=5, threshold=1)),
        (rng.uniform(-1, 3, 9).astype(np.float32),
         dict(pitch=0.5, origin=-0.7, dims=11, threshold=1.5)),
    ]:
        want = np.asarray(JF.occupancy_grid_1d(jnp.asarray(points), **kw))
        got = TF.occupancy_grid_1d(torch.from_numpy(points), **kw).numpy()
        np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=0)


def test_occupancy_grid_2d_matches_jax():
    points = np.random.RandomState(5).uniform(0, 3, (8, 2)).astype(
        np.float32)
    kw = dict(pitch=0.6, origin=(-0.1, 0.2), dims=(6, 5), threshold=2)
    want = np.asarray(JF.occupancy_grid_2d(
        jnp.asarray(points), **dict(kw, origin=np.float32(kw["origin"]))))
    p = torch.from_numpy(points).requires_grad_(True)
    got = TF.occupancy_grid_2d(p, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=VALUE_ATOL,
                               rtol=0)
    w = np.random.RandomState(6).rand(6, 5).astype(np.float32)
    g_want = np.asarray(jax.grad(lambda q: jnp.sum(JF.occupancy_grid_2d(
        q, **dict(kw, origin=np.float32(kw["origin"]))) * w))(
        jnp.asarray(points)))
    torch.sum(got * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(p.grad.numpy(), g_want,
                               atol=GRAD_RTOL * np.abs(g_want).max(), rtol=0)


def test_occupancy_grid_3d_goes_through_the_min_distance_op(monkeypatch):
    """The 3-D grid reaches ``ops.min_dist.min_dist_voxels`` once, with
    points in voxel units (the wrapper that launches the kernel on the
    card)."""
    from morefusion_tpu_torch.ops import min_dist as md

    calls = []
    real = md.min_dist_voxels

    def spy(ip, valid, payload, dims):
        calls.append((ip.clone(), dims))
        return real(ip, valid, payload, dims)

    monkeypatch.setattr(md, "min_dist_voxels", spy)
    points = torch.tensor([[0.1, 0.2, 0.3]])
    TO.occupancy_grid_3d(points, pitch=0.5, origin=(0.0, 0.0, 0.0),
                         dims=(3, 3, 3))
    assert len(calls) == 1
    assert torch.equal(calls[0][0], (points / 0.5)[None])
    assert calls[0][1] == (3, 3, 3)
