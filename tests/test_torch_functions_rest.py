"""The rest of the port's ``functions/`` against ``morefusion_tpu.functions``:
``max_voxelization_3d``, ``interpolate_voxel_grid_sorted`` and
``truncated_distance_function_scatter``.

The same float32 inputs from a numpy seed on the CPU. The scatter-max's
grid, winners and gradients are held bit for bit (a gather of the winners'
values); the sorted interpolation's values and gradients equal the port's
``interpolate_voxel_grid``'s (whose backward is already sorted on the card)
and JAX's ``interpolate_voxel_grid_sorted`` within 1e-6 (JAX's point
gradient is a closed form that groups the products differently from
autograd's); the neighbourhood TDF's
field within 1e-6 and its winners exactly (continuous random points, so no
two pairs tie), its gradient within 1e-5 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu import functions as JF
from morefusion_tpu.functions import tdf as jtdf
from morefusion_tpu_torch import functions as TF
from morefusion_tpu_torch.functions import tdf as ttdf

torch.set_num_threads(2)

VALUE_ATOL = 1e-6
GRAD_RTOL = 1e-5


def _voxel_inputs(seed, P=200, C=5, B=2, dims=(6, 5, 7), ties=False,
                  nan=False):
    rng = np.random.RandomState(seed)
    values = rng.normal(size=(P, C)).astype(np.float32)
    # a margin around the grid, so that some points fall outside
    points = rng.uniform(-0.15, 0.8, (P, 3)).astype(np.float32)
    batch = rng.randint(0, B, P).astype(np.int32)
    intensities = rng.rand(P).astype(np.float32)
    if ties:  # a few intensity levels: many voxels hold a tie
        intensities = np.round(intensities * 3).astype(np.float32)
    if nan:
        points[::17, 1] = np.nan
    kw = dict(batch_size=B, origin=np.float32([-0.05, 0.0, 0.02]),
              pitch=0.1, dimensions=dims)
    return values, points, batch, intensities, kw


CASES = [dict(), dict(ties=True), dict(nan=True), dict(ties=True, nan=True)]


@pytest.mark.parametrize("case", CASES, ids=["plain", "ties", "nan",
                                             "ties_nan"])
def test_max_voxelization_3d_matches_jax(case):
    values, points, batch, intensities, kw = _voxel_inputs(0, **case)
    g_out = np.random.RandomState(1).normal(
        size=(kw["batch_size"],) + kw["dimensions"] + (values.shape[1],)
    ).astype(np.float32)

    def jax_fn(v):
        return JF.max_voxelization_3d(v, points, batch, intensities, **kw,
                                      return_indices=True)

    (j_grid, j_idx) = jax_fn(jnp.asarray(values))
    j_grad = jax.grad(lambda v: jnp.sum(jax_fn(v)[0] * g_out))(
        jnp.asarray(values))
    v = torch.from_numpy(values).requires_grad_(True)
    grid, idx = TF.max_voxelization_3d(
        v, torch.from_numpy(points), torch.from_numpy(batch),
        torch.from_numpy(intensities), **kw, return_indices=True)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(grid.detach().numpy(), np.asarray(j_grid))
    (grid * torch.from_numpy(g_out)).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(j_grad))
    assert (idx >= 0).sum() > 10
    grid_only = TF.max_voxelization_3d(
        v, torch.from_numpy(points), torch.from_numpy(batch),
        torch.from_numpy(intensities), **kw)
    assert torch.equal(grid_only, grid)


def test_max_voxelization_3d_lowest_index_wins_a_tie():
    """Three points in one voxel, two of them at the highest intensity:
    the lower of those two wins; NaN points never do."""
    values = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    points = torch.tensor([[0.01, 0.0, 0.0], [0.02, 0.0, 0.0],
                           [0.0, 0.01, 0.0], [np.nan, 0.0, 0.0]])
    intensities = torch.tensor([0.5, 0.9, 0.9, 5.0])
    grid, idx = TF.max_voxelization_3d(
        values, points, torch.zeros(4, dtype=torch.int32), intensities,
        batch_size=1, origin=(0.0, 0.0, 0.0), pitch=0.1, dimensions=2,
        return_indices=True)
    assert idx[0, 0, 0, 0] == 1
    assert torch.equal(grid[0, 0, 0, 0], values[1])
    assert (idx.reshape(-1)[1:] == -1).all()


def _interp_inputs(seed, P=150, C=4, B=2, dims=(5, 6, 4)):
    rng = np.random.RandomState(seed)
    grid = rng.normal(size=(B,) + dims + (C,)).astype(np.float32)
    # voxel coordinates, some beyond the grid on each side
    points = rng.uniform(-1.5, max(dims) + 0.5, (P, 3)).astype(np.float32)
    batch = rng.randint(0, B, P).astype(np.int32)
    cot = rng.normal(size=(P, C)).astype(np.float32)
    return grid, points, batch, cot


def _torch_interp(fn, grid, points, batch, cot):
    g = torch.from_numpy(grid).requires_grad_(True)
    p = torch.from_numpy(points).requires_grad_(True)
    out = fn(g, p, torch.from_numpy(batch))
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), g.grad.numpy(), p.grad.numpy()


def _same_as_plain(got, plain):
    """Values and grid gradient bit for bit, point gradient within 1e-6."""
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])
    np.testing.assert_allclose(got[2], plain[2], rtol=0,
                               atol=VALUE_ATOL * np.abs(plain[2]).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_interpolate_voxel_grid_sorted(seed):
    grid, points, batch, cot = _interp_inputs(seed)
    inside = ((points >= 0) & (points <= np.array([4, 5, 3]))).all(1)
    assert inside.any() and (~inside).any()
    got = _torch_interp(TF.interpolate_voxel_grid_sorted, grid, points,
                        batch, cot)
    _same_as_plain(got, _torch_interp(TF.interpolate_voxel_grid, grid,
                                      points, batch, cot))

    def jax_fn(g, p):
        return JF.interpolate_voxel_grid_sorted(g, p, jnp.asarray(batch))

    j_out = jax_fn(jnp.asarray(grid), jnp.asarray(points))
    j_dg, j_dp = jax.grad(lambda g, p: jnp.sum(jax_fn(g, p) * cot),
                          argnums=(0, 1))(jnp.asarray(grid),
                                          jnp.asarray(points))
    for g, w in zip(got, (j_out, j_dg, j_dp)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=VALUE_ATOL * max(1, np.abs(w).max()))


def test_interpolate_voxel_grid_sorted_collisions():
    """Many points in few voxels: each voxel's gradient sums many corner
    contributions, in point order as the plain backward adds them."""
    rng = np.random.RandomState(3)
    grid = rng.normal(size=(1, 3, 3, 3, 2)).astype(np.float32)
    points = rng.uniform(0.2, 1.8, (500, 3)).astype(np.float32)
    batch = np.zeros(500, np.int32)
    cot = rng.normal(size=(500, 2)).astype(np.float32)
    got = _torch_interp(TF.interpolate_voxel_grid_sorted, grid, points,
                        batch, cot)
    _same_as_plain(got, _torch_interp(TF.interpolate_voxel_grid, grid,
                                      points, batch, cot))


def _tdf_inputs(seed, P=60, dims=(12, 10, 11)):
    rng = np.random.RandomState(seed)
    points = rng.uniform(-0.01, 0.11, (P, 3)).astype(np.float32)
    kw = dict(pitch=0.01, origin=np.float32([0.0, 0.005, -0.002]),
              dims=dims, truncation=0.03)
    return points, kw


@pytest.mark.parametrize("ksize", [None, 4, 5])
def test_truncated_distance_function_scatter_matches_jax(ksize):
    points, kw = _tdf_inputs(0)
    j_tdf, j_idx = jtdf.truncated_distance_function_scatter(
        jnp.asarray(points), **kw, return_indices=True, ksize=ksize)
    t_tdf, t_idx = ttdf.truncated_distance_function_scatter(
        torch.from_numpy(points), **kw, return_indices=True, ksize=ksize)
    np.testing.assert_allclose(t_tdf.numpy(), np.asarray(j_tdf), rtol=0,
                               atol=VALUE_ATOL)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert (t_idx >= 0).any() and (t_idx < 0).any()
    only = ttdf.truncated_distance_function_scatter(
        torch.from_numpy(points), **kw, ksize=ksize)
    assert torch.equal(only, t_tdf)


def test_truncated_distance_function_scatter_gradients():
    points, kw = _tdf_inputs(1)
    w = np.random.RandomState(2).rand(*kw["dims"]).astype(np.float32)
    j_grad = np.asarray(jax.grad(lambda p: jnp.sum(
        jtdf.truncated_distance_function_scatter(p, **kw) * w))(
        jnp.asarray(points)))
    p = torch.from_numpy(points).requires_grad_(True)
    (ttdf.truncated_distance_function_scatter(p, **kw)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), j_grad, rtol=0,
                               atol=GRAD_RTOL * np.abs(j_grad).max())


def test_truncated_distance_function_scatter_within_the_exact_field():
    """Where the neighbourhood reaches, the scatter equals the exact field
    of ``truncated_distance_function``; elsewhere it reads at least it."""
    points, kw = _tdf_inputs(4)
    exact = TF.truncated_distance_function(torch.from_numpy(points), **kw)
    scatter = ttdf.truncated_distance_function_scatter(
        torch.from_numpy(points), **kw, ksize=7)
    assert (scatter >= exact - VALUE_ATOL).all()
    near = exact < 0.02
    np.testing.assert_allclose(scatter[near].numpy(), exact[near].numpy(),
                               rtol=0, atol=VALUE_ATOL)
