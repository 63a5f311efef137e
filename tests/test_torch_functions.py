"""The port's differentiable geometry ops against the JAX package.

Same float32 inputs, made from a seed with numpy, through
``morefusion_tpu.functions`` (JAX on the CPU) and
``morefusion_tpu_torch.functions``. Values and gradients agree to float32
rounding (atol 1e-5 to 1e-4 by the size of the sums), except where stated.
Distance fields differ a little more: JAX forms the squared voxel distance
as ``c2 + p2 - 2 c.p`` and the port as a sum of squares, a few float32 ulps
of ``|c|^2`` apart, which is up to ~5e-5 in a grid value ``1 - d / trunc``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu import functions as JF
from morefusion_tpu.functions import tdf as jtdf
from morefusion_tpu_torch import functions as TF

torch.set_num_threads(2)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def test_quaternion_and_transformation_matrix(rng):
    q = rng.normal(size=(5, 4)).astype(np.float32)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    w = rng.normal(size=(5, 4, 4)).astype(np.float32)

    def jf(q, t):
        return jnp.sum(JF.transformation_matrix(q, t) * w)

    jv, (jgq, jgt) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(q, t)
    tq, tt = _t(q, True), _t(t, True)
    T = TF.transformation_matrix(tq, tt)
    np.testing.assert_allclose(
        T.detach().numpy(), np.asarray(JF.transformation_matrix(q, t)),
        atol=1e-6)
    (T * _t(w)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), jgq, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), jgt, atol=1e-5)
    np.testing.assert_allclose(
        TF.quaternion_matrix(_t(q[0])).numpy(),
        np.asarray(JF.quaternion_matrix(q[0])), atol=1e-6)


def test_transform_points(rng):
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    q = rng.normal(size=(3, 4)).astype(np.float32)
    T = np.asarray(JF.transformation_matrix(q, rng.normal(size=(3, 3))
                                            .astype(np.float32)))
    np.testing.assert_allclose(
        TF.transform_points(_t(pts), _t(T)).numpy(),
        np.asarray(JF.transform_points(pts, T)), atol=1e-5)
    np.testing.assert_allclose(
        TF.transform_points(_t(pts), _t(T[0])).numpy(),
        np.asarray(JF.transform_points(pts, T[0])), atol=1e-5)
    batched = np.stack([pts, 2 * pts, -pts])
    expect = np.stack([np.asarray(JF.transform_points(p, T[i]))
                       for i, p in enumerate(batched)])
    np.testing.assert_allclose(
        TF.transform_points(_t(batched), _t(T)).numpy(), expect, atol=1e-5)


def test_average_voxelization_3d(rng):
    P, C, B = 200, 5, 2
    pts = rng.uniform(-0.5, 6.5, (P, 3)).astype(np.float32)
    pts[3] = np.nan
    vals = rng.normal(size=(P, C)).astype(np.float32)
    bidx = rng.randint(0, B, P).astype(np.int32)
    kw = dict(batch_size=B, origin=(0.1, -0.2, 0.0), pitch=0.9,
              dimensions=(6, 5, 7))
    w = rng.normal(size=(B, 6, 5, 7, C)).astype(np.float32)

    def jf(v):
        return jnp.sum(JF.average_voxelization_3d(v, pts, bidx, **kw) * w)

    jgrid, jcount = JF.average_voxelization_3d(vals, pts, bidx,
                                               return_counts=True, **kw)
    tv = _t(vals, True)
    grid, count = TF.average_voxelization_3d(
        tv, _t(pts), _t(bidx), return_counts=True, **kw)
    np.testing.assert_allclose(grid.detach().numpy(), jgrid, atol=1e-5)
    np.testing.assert_array_equal(count.numpy(), jcount)
    (grid * _t(w)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), jax.jit(jax.grad(jf))(vals),
                               atol=1e-5)


def test_interpolate_voxel_grid(rng):
    B, C, P = 2, 3, 50
    grid = rng.normal(size=(B, 5, 6, 4, C)).astype(np.float32)
    pts = rng.uniform(-1.5, 6.5, (P, 3)).astype(np.float32)
    bidx = rng.randint(0, B, P).astype(np.int32)
    w = rng.normal(size=(P, C)).astype(np.float32)

    def jf(g, p):
        return jnp.sum(JF.interpolate_voxel_grid(g, p, bidx) * w)

    jg, jp = jax.jit(jax.grad(jf, argnums=(0, 1)))(grid, pts)
    tg, tp = _t(grid, True), _t(pts, True)
    out = TF.interpolate_voxel_grid(tg, tp, _t(bidx))
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(JF.interpolate_voxel_grid(grid, pts, bidx)), atol=1e-5)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(tg.grad.numpy(), jg, atol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), jp, atol=1e-4)


def _tdf_inputs(rng, case):
    B, P, V = 3, 60, 8
    pts = rng.uniform(-0.01, 0.09, (B, P, 3)).astype(np.float32)
    mask = np.ones((B, P), bool)
    if case == "masked":
        mask &= rng.rand(B, P) > 0.3
        mask[2] = False
    if case == "nan":
        pts[0, :7, 1] = np.nan
    if case == "ties":
        # exact duplicates: both sides give the tie to the lower index
        pts[:, P // 2:] = pts[:, : P // 2]
    pitch = np.array([0.01, 0.012, 0.009], np.float32)
    origin = rng.uniform(-0.01, 0.0, (B, 3)).astype(np.float32)
    payload = rng.randint(0, 1 << 14, (B, P)).astype(np.int32)
    return pts, mask, pitch, origin, payload, (V, V, V)


@pytest.mark.parametrize("case", ["plain", "masked", "nan", "ties"])
def test_min_dist_values_winners_payloads_and_grads(rng, case):
    """``_min_dist`` through ``truncated_distance_function``. Gradients
    only flow to winning points, so a winner flipped by a float32 near-tie
    would move a gradient between points: the inputs are drawn away from
    such ties (exact ties are duplicates, decided alike on both sides)."""
    pts, mask, pitch, origin, payload, dims = _tdf_inputs(rng, case)
    trunc = 3 * pitch
    w = rng.normal(size=(3,) + dims).astype(np.float32)
    kw = dict(pitch=pitch, origin=origin, dims=dims, truncation=trunc,
              point_mask=mask, payload_q=payload, return_indices=True,
              return_payload=True)

    def jf(p):
        tdf, _, _ = jtdf.truncated_distance_function(p, **kw)
        return jnp.sum(tdf * w)

    jtdf_, jidx, jpay = jax.jit(
        lambda p: jtdf.truncated_distance_function(p, **kw))(pts)
    jg = jax.jit(jax.grad(jf))(pts)
    tp = _t(pts, True)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ttdf, tidx, tpay = TF.truncated_distance_function(tp, **tkw)
    np.testing.assert_allclose(ttdf.detach().numpy(), jtdf_, atol=1e-6)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tpay.numpy(), jpay)
    (ttdf * _t(w)).sum().backward()
    g = tp.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, jg, atol=2e-3, rtol=1e-4)


def test_truncated_distance_function_unbatched(rng):
    pts, _, pitch, origin, _, dims = _tdf_inputs(rng, "plain")
    kw = dict(pitch=float(pitch[0]), origin=origin[0], dims=dims,
              truncation=0.03)
    j = jtdf.truncated_distance_function(pts[0], **kw)
    t = TF.truncated_distance_function(
        _t(pts[0]), **dict(kw, origin=_t(origin[0])))
    assert t.shape == dims
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6)


@pytest.mark.parametrize("sdf_offset", [0.0, -0.005])
def test_pseudo_occupancy_voxelization(rng, sdf_offset):
    pts, mask, pitch, origin, _, dims = _tdf_inputs(rng, "masked")
    sdf = rng.uniform(0, 0.02, pts.shape[:2]).astype(np.float32)
    kw = dict(pitch=pitch, origin=origin, dims=dims, threshold=2.0,
              sdf_offset=sdf_offset, point_mask=mask)
    jg = jtdf.pseudo_occupancy_voxelization(pts, sdf, **kw)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tg = TF.pseudo_occupancy_voxelization(_t(pts), _t(sdf), **tkw)
    for a, b in zip(tg, jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=5e-5)
