"""The port's min-distance op against the JAX package's exact XLA path.

``morefusion_tpu_torch.ops.min_dist`` (plain version on the CPU, the CUDA
kernel on the card) is held to ``morefusion_tpu.functions.tdf._scan_core``
on the same float32 inputs, made from a seed with numpy.

Tolerances: d2 within 1e-4 voxel^2, because JAX forms d2 as
``c2 + p2 - 2 c.p`` (terms up to ~|c|^2 = 200 here cancel, a few float32
ulps) and the port as a direct sum of squares. Winners must be equal
wherever the best and second-best d2 (float64 oracle) differ by more than
1e-3; payloads wherever winners are equal.

The edge cases of the kernel's design (a grid its voxel tile does not
divide, P no multiple of its splits, exact ties across splits, d2 that
overflows, all points masked) hold the plain version to a numpy evaluation
of the contract, and on the card the kernel to the plain version, both
bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from morefusion_tpu.functions.tdf import _scan_core
from morefusion_tpu_torch.ops import min_dist as md

torch.set_num_threads(2)

DIMS = (8, 7, 6)


def _inputs(rng, B, P, case):
    ip = rng.uniform(-2, 10, (B, P, 3)).astype(np.float32)
    valid = np.ones((B, P), bool)
    if case in ("masked", "mixed"):
        valid &= rng.rand(B, P) > 0.3
    if case in ("nan", "mixed"):
        ip[0, rng.choice(P, P // 4, replace=False), rng.randint(3)] = np.nan
    if case in ("empty_lane", "mixed"):
        valid[-1] = False
    if case == "ties":
        # duplicated integer points: exact ties that the lowest index wins
        ip = np.round(ip)
        ip[:, P // 2:] = ip[:, : P - P // 2]
    payload = rng.randint(0, 1 << 14, (B, P)).astype(np.int32)
    return ip, valid, payload


def _oracle_gap(ip, valid):
    """(B, V) float64 gap between the best and second-best valid d2."""
    c = md.voxel_centers(DIMS, "cpu").numpy().astype(np.float64)
    ok = valid & ~np.isnan(ip).any(-1)
    d2 = ((c[None, :, None, :] - ip[:, None, :, :]) ** 2).sum(-1)
    d2 = np.where(ok[:, None, :], d2, np.inf)
    d2 = np.concatenate([d2, np.full(d2.shape[:2] + (1,), np.inf)], -1)
    part = np.sort(d2, axis=-1)[..., :2]
    with np.errstate(invalid="ignore"):
        return part[..., 1] - part[..., 0]


def _jax_reference(ip, valid, payload):
    d2s, args = [], []
    for b in range(ip.shape[0]):
        ok = valid[b] & ~np.isnan(ip[b]).any(-1)
        d2, arg = _scan_core(jnp.asarray(np.nan_to_num(ip[b])),
                             jnp.asarray(ok), DIMS, 32)
        d2s.append(np.asarray(d2))
        args.append(np.asarray(arg))
    d2, arg = np.stack(d2s), np.stack(args)
    pay = np.where(arg >= 0,
                   np.take_along_axis(payload, np.maximum(arg, 0), 1), 0)
    return d2, arg, pay


def _assert_matches(out, ref, gap):
    d2, arg, pay = (t.cpu().numpy() for t in out)
    rd2, rarg, rpay = ref
    np.testing.assert_array_equal(np.isinf(d2), np.isinf(rd2))
    fin = np.isfinite(rd2)
    np.testing.assert_allclose(d2[fin], rd2[fin], atol=1e-4, rtol=0)
    clear = gap > 1e-3
    np.testing.assert_array_equal(arg[clear], rarg[clear])
    np.testing.assert_array_equal(arg[~fin], -1)
    same = arg == rarg
    np.testing.assert_array_equal(pay[same], rpay[same])
    np.testing.assert_array_equal(pay[arg < 0], 0)


@pytest.mark.parametrize("case", ["plain", "masked", "nan", "empty_lane",
                                  "ties", "mixed"])
@pytest.mark.parametrize("P", [1, 37, 300])
def test_min_dist_plain_matches_scan_core(rng, case, P):
    ip, valid, payload = _inputs(rng, 3, P, case)
    out = md.min_dist_voxels(torch.from_numpy(ip), torch.from_numpy(valid),
                             torch.from_numpy(payload), DIMS)
    _assert_matches(out, _jax_reference(ip, valid, payload),
                    _oracle_gap(ip, valid))


def test_min_dist_ties_go_to_lowest_index(rng):
    ip, valid, payload = _inputs(rng, 2, 64, "ties")
    _, arg, _ = md.min_dist_voxels(torch.from_numpy(ip),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(payload), DIMS)
    assert int(arg.max()) < 32  # the duplicates sit at indices 32..63


def test_plain_chunking_does_not_change_the_result(rng):
    ip, valid, payload = _inputs(rng, 2, 130, "mixed")
    args = (torch.from_numpy(ip), torch.from_numpy(valid),
            torch.from_numpy(payload), DIMS)
    a = md.min_dist_voxels_plain(*args, chunk=7)
    b = md.min_dist_voxels_plain(*args, chunk=256)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_cpu_call_counts_no_launch(rng):
    ip, valid, payload = _inputs(rng, 1, 10, "plain")
    before = md.min_dist_voxels.launches
    md.min_dist_voxels(torch.from_numpy(ip), torch.from_numpy(valid),
                       torch.from_numpy(payload), DIMS)
    assert md.min_dist_voxels.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "valid", "payload",
                                 "dims", "device"])
def test_wrapper_rejects_bad_arguments(bad):
    ip = torch.zeros(2, 5, 3)
    valid = torch.ones(2, 5, dtype=torch.bool)
    payload = torch.zeros(2, 5, dtype=torch.int32)
    dims = (4, 4, 4)
    if bad == "dtype":
        ip = ip.double()
    elif bad == "shape":
        ip = ip[..., :2]
    elif bad == "valid":
        valid = valid.int()
    elif bad == "payload":
        payload = payload[:, :4]
    elif bad == "dims":
        dims = (4, 0, 4)
    elif bad == "device":
        ip, valid, payload = (t.to("meta") for t in (ip, valid, payload))
    with pytest.raises(ValueError):
        md.min_dist_voxels(ip, valid, payload, dims)


def _edge_inputs(case):
    """``(ip, valid, payload, dims)`` for one edge case of the kernel."""
    g = np.random.RandomState(len(case))
    B, P, dims = 3, 300, (8, 7, 6)
    if case == "ragged_grid":
        dims = (9, 5, 11)  # the kernel's 2 x 4 x 4 voxel tile divides none
    if case == "prime_p":
        P = 701
    if case == "split_ties":
        P = 700
    if case == "one_point":
        B, P, dims = 2, 1, (9, 5, 11)
    ip = g.uniform(-2, max(dims) + 2, (B, P, 3)).astype(np.float32)
    valid = g.rand(B, P) > 0.1
    if case == "split_ties":
        # integer points, the first half repeated as the second: exact ties
        # between points P // 2 apart, in different splits of the kernel
        ip = np.round(ip)
        ip[:, P // 2:] = ip[:, :P // 2]
        valid[:, P // 2:] = valid[:, :P // 2]
    if case == "overflow":
        # valid points whose d2 overflows to inf: lane 0 holds only such
        # points, lane 1 one of them among finite ones
        ip[0] = g.choice([-3e38, 3e38], (P, 3))
        ip[1, 0] = 3e38
        valid[:2] = True
    if case == "all_masked":
        valid[:] = False
    payload = g.randint(0, 1 << 14, (B, P)).astype(np.int32)
    return ip, valid, payload, dims


def _numpy_contract(ip, valid, payload, dims):
    """The contract in numpy float32: d2 = (dx*dx + dy*dy) + dz*dz, each
    operation rounded; the lowest index among the valid, non-NaN points of
    least finite d2; -1, inf and payload 0 where there is none."""
    c = md.voxel_centers(dims, "cpu").numpy()  # (V, 3) float32
    d = c[None, :, None, :] - ip[:, None, :, :]  # (B, V, P, 3)
    with np.errstate(over="ignore", invalid="ignore"):
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
    ok = valid & ~np.isnan(ip).any(-1)
    d2 = np.where(ok[:, None, :] & np.isfinite(d2), d2, np.float32(np.inf))
    best = d2.min(-1)
    arg = np.where(np.isfinite(best), d2.argmin(-1), -1).astype(np.int32)
    pay = np.where(arg >= 0,
                   np.take_along_axis(payload, np.maximum(arg, 0), 1), 0)
    return best.astype(np.float32), arg, pay.astype(np.int32)


EDGE_CASES = ["ragged_grid", "prime_p", "split_ties", "overflow",
              "all_masked", "one_point"]


def _assert_bitwise(out, ref):
    d2, arg, pay = (np.asarray(t) for t in out)
    rd2, rarg, rpay = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(d2.view(np.int32), rd2.view(np.int32))
    np.testing.assert_array_equal(arg, rarg)
    np.testing.assert_array_equal(pay, rpay)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_matches_numpy_contract_on_edge_cases(case):
    ip, valid, payload, dims = _edge_inputs(case)
    out = md.min_dist_voxels_plain(torch.from_numpy(ip),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(payload), dims)
    want = _numpy_contract(ip, valid, payload, dims)
    _assert_bitwise([t.numpy() for t in out], want)
    if case == "split_ties":
        assert want[1].max() < ip.shape[1] // 2
    if case == "overflow":
        assert (want[1][0] == -1).all() and (want[1][1] != 0).all()


def _card_inputs(case):
    """``(ip, valid, payload, dims)`` for the card test: ``P`` points on the
    ICC grid with NaN and masked points and an empty lane, or an edge case."""
    if case in EDGE_CASES:
        return _edge_inputs(case)
    P = int(case)
    g = np.random.RandomState(P)
    B, dims = 4, (32, 32, 32)
    ip = (g.rand(B, P, 3) * 36 - 2).astype(np.float32)
    ip[0, :100, 1] = np.nan
    valid = g.rand(B, P) > 0.2
    valid[-1] = False
    payload = g.randint(0, 1 << 14, (B, P)).astype(np.int32)
    return ip, valid, payload, dims


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["2048", "2000", "16384", *EDGE_CASES])
def test_kernel_matches_plain_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    ip, valid, payload, dims = _card_inputs(case)
    args = [torch.from_numpy(a).cuda() for a in (ip, valid, payload)]
    before = md.min_dist_voxels.launches
    out = md.min_dist_voxels(*args, dims)
    torch.cuda.synchronize()
    assert md.min_dist_voxels.launches == before + 1
    ref = md.min_dist_voxels_plain(*args, dims)
    # identical arithmetic (no FMA contraction): bit-equal results
    _assert_bitwise([t.cpu().numpy() for t in out],
                    [t.cpu().numpy() for t in ref])
