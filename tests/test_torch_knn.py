"""The port's nearest-neighbour op against the JAX package's ``functions.knn.nn``.

``morefusion_tpu_torch.functions.knn.nn`` (plain version on the CPU, the
CUDA kernel on the card) is held to ``morefusion_tpu.functions.knn.nn`` on
the same float32 inputs, made from a seed with numpy.

Tolerances: JAX forms ``|q|^2 + |r|^2 - 2 q.r`` and the port a direct sum of
squares, so at a near-tie the two may pick different points. At least 99.9%
of the indices must agree. Wherever they differ, near the origin the two
chosen points' distances to the query (float64) must agree within 1e-5
relative. At 0.8 m from the origin, where training puts the objects, the
expansion's float32 rounding (a few ulps of ``|q|^2 + |r|^2`` ~ 1.3) exceeds
that: there the port's point must be the nearer one in float64 (up to
float32 rounding of its own sum) and the two squared distances must agree
within 2^-20 (|q|^2 + |r|^2), the expansion's error bound. The plain version
is held to the same arithmetic in numpy exactly, and on the card the kernel
to the plain version exactly. The edge cases of the kernel's design (a query
count that fills no whole block, exact ties across its shared-memory tiles,
NaN and overflowing distances) hold the plain version to a numpy evaluation
of the contract, and on the card the kernel to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu.functions import knn as jknn
from morefusion_tpu_torch.functions import knn as tknn
from morefusion_tpu_torch.ops import knn as ops_knn

torch.set_num_threads(2)

AGREE = 0.999
DIST_RTOL = 1e-5


def _inputs(seed, B, R, Q, case):
    g = np.random.RandomState(seed)
    ref = g.uniform(-0.1, 0.1, (B, R, 3)).astype(np.float32)
    query = g.uniform(-0.12, 0.12, (B, Q, 3)).astype(np.float32)
    if case == "far":
        ref[..., 2] += 0.8
        query[..., 2] += 0.8
    if case == "ties":
        # integer points (exact in both formulas), every reference point
        # twice: exact ties that the lowest index must win
        ref = g.randint(-4, 5, (B, R, 3)).astype(np.float32)
        ref[:, R // 2:] = ref[:, : R - R // 2]
        query = g.randint(-5, 6, (B, Q, 3)).astype(np.float32)
    return ref, query


def _numpy_nn(ref, query):
    """The port's arithmetic in numpy float32: argmin of
    ``(dx*dx + dy*dy) + dz*dz``, first index on a tie."""
    d = query[:, :, None, :] - ref[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return np.argmin(d2, axis=-1).astype(np.int32)


def _assert_agrees_with_jax(ref, query, got, far):
    want = np.stack([np.asarray(jknn.nn(jnp.asarray(r), jnp.asarray(q)))
                     for r, q in zip(ref, query)])
    assert got.shape == want.shape and got.dtype == np.int32
    same = got == want
    assert same.mean() >= AGREE, same.mean()
    b, q = np.nonzero(~same)
    p = query[b, q].astype(np.float64)
    r_got = ref[b, got[b, q]].astype(np.float64)
    r_want = ref[b, want[b, q]].astype(np.float64)
    d2_got = ((r_got - p) ** 2).sum(-1)
    d2_want = ((r_want - p) ** 2).sum(-1)
    if not far:
        np.testing.assert_allclose(np.sqrt(d2_got), np.sqrt(d2_want),
                                   rtol=DIST_RTOL, atol=0)
        return
    scale = (p ** 2).sum(-1) + (r_want ** 2).sum(-1)
    assert (d2_got <= d2_want + 2.0**-23 * d2_want).all()
    assert (np.abs(d2_got - d2_want) <= 2.0**-20 * scale).all()


@pytest.mark.parametrize("case,B,R,Q", [
    ("random", 2, 50, 300),
    ("far", 2, 500, 3000),
    ("ties", 2, 64, 500),
    ("above_tpu_cap", 1, 17000, 64),
])
def test_nn_matches_jax(case, B, R, Q):
    ref, query = _inputs(B * R + Q, B, R, Q, case)
    got = tknn.nn(torch.from_numpy(ref), torch.from_numpy(query)).numpy()
    _assert_agrees_with_jax(ref, query, got, far=case == "far")
    if case == "ties":
        # every tie went to the first copy of the point
        assert (got < R - R // 2).all()


@pytest.mark.parametrize("block", [7, 1000, 1 << 25])
def test_plain_equals_its_arithmetic_in_numpy(monkeypatch, block):
    """Any chunking of the queries gives the same indices, equal to the
    same float32 arithmetic in numpy."""
    monkeypatch.setattr(ops_knn, "_PLAIN_BLOCK", block)
    ref, query = _inputs(3, 3, 40, 251, "random")
    got = ops_knn.nn_indices_plain(torch.from_numpy(ref),
                                   torch.from_numpy(query))
    np.testing.assert_array_equal(got.numpy(), _numpy_nn(ref, query))


def test_nan_and_infinite_queries_get_index_zero():
    ref, query = _inputs(4, 1, 10, 4, "random")
    query[0, 1] = np.nan
    query[0, 2, 0] = np.inf
    got = ops_knn.nn_indices(torch.from_numpy(ref), torch.from_numpy(query))
    assert got[0, 1] == 0 and got[0, 2] == 0
    np.testing.assert_array_equal(got[0, [0, 3]].numpy(),
                                  _numpy_nn(ref, query)[0, [0, 3]])


def test_nn_has_no_gradient():
    ref, query = (torch.from_numpy(a).requires_grad_()
                  for a in _inputs(5, 2, 8, 16, "random"))
    idx = tknn.nn(ref, query)
    assert idx.dtype == torch.int32 and not idx.requires_grad


@pytest.mark.parametrize("bad", ["float64", "lanes", "empty_ref", "dims"])
def test_bad_inputs_raise(bad):
    ref, query = (torch.from_numpy(a) for a in _inputs(6, 2, 8, 16, "random"))
    if bad == "float64":
        ref = ref.double()
    elif bad == "lanes":
        query = query[:1]
    elif bad == "empty_ref":
        ref = ref[:, :0]
    else:
        query = query[..., :2]
    with pytest.raises(ValueError):
        ops_knn.nn_indices(ref, query)


def _edge_inputs(case):
    """``(ref, query)`` for one edge case of the kernel, which takes 1024
    queries a block and 2048 references a shared-memory tile."""
    g = np.random.RandomState(len(case))
    if case == "ragged_block":
        return _inputs(8, 2, 37, 3 * 1024 + 1, "random")
    if case == "ties_across_tiles":
        # every reference twice, 2500 apart: ties across tiles and sub-tiles
        return _inputs(9, 2, 5000, 200, "ties")
    ref, query = _inputs(10, 2, 40, 300, "random")
    if case == "nan":
        ref[0, g.choice(40, 10, replace=False), g.randint(3)] = np.nan
        query[1, :50, 0] = np.nan
        query[1, 50:60] = np.inf
    if case == "overflow":
        # d2 overflows to inf: lane 0's queries are that far from every
        # reference, lane 1 has one reference that far
        query[0, :, 2] = 3e38
        ref[1, 5] = -3e38
    return ref, query


def _numpy_contract_nn(ref, query):
    """The contract in numpy float32: argmin of ``(dx*dx + dy*dy) + dz*dz``
    with NaN as inf, the first index on a tie, 0 where nothing is finite."""
    d = query[:, :, None, :] - ref[:, None, :, :]
    with np.errstate(over="ignore", invalid="ignore"):
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
    d2 = np.where(np.isnan(d2), np.float32(np.inf), d2)
    return np.argmin(d2, axis=-1).astype(np.int32)


KNN_EDGE_CASES = ["ragged_block", "ties_across_tiles", "nan", "overflow"]


@pytest.mark.parametrize("case", KNN_EDGE_CASES)
def test_plain_matches_numpy_contract_on_edge_cases(case):
    ref, query = _edge_inputs(case)
    got = ops_knn.nn_indices_plain(torch.from_numpy(ref),
                                   torch.from_numpy(query)).numpy()
    np.testing.assert_array_equal(got, _numpy_contract_nn(ref, query))
    if case == "ties_across_tiles":
        assert (got < ref.shape[1] // 2).all()
    if case == "overflow":
        assert (got[0] == 0).all() and (got[1] != 5).all()


# the card test's cases besides the edge cases: (B, R, Q) of _inputs
CARD_SHAPES = {"one_ref": (2, 1, 1000), "ties": (2, 64, 4096),
               "ragged": (3, 500, 1000 * 50 + 17),
               "above_tpu_cap": (1, 20000, 3000), "one_lane": (1, 500, 5000)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CARD_SHAPES, *KNN_EDGE_CASES])
def test_kernel_matches_plain_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    inputs = (_inputs(7, *CARD_SHAPES[case], case) if case in CARD_SHAPES
              else _edge_inputs(case))
    ref, query = (torch.from_numpy(a).cuda() for a in inputs)
    before = ops_knn.nn_indices.launches
    got = ops_knn.nn_indices(ref, query)
    torch.cuda.synchronize()
    assert ops_knn.nn_indices.launches == before + 1
    torch.testing.assert_close(got, ops_knn.nn_indices_plain(ref, query),
                               rtol=0, atol=0)
