"""The port's min-distance op against the JAX package's exact XLA path.

``morefusion_tpu_torch.ops.min_dist`` (plain version on the CPU, the CUDA
kernel on the card) is held to ``morefusion_tpu.functions.tdf._scan_core``
on the same float32 inputs, made from a seed with numpy.

Tolerances: d2 within 1e-4 voxel^2, because JAX forms d2 as
``c2 + p2 - 2 c.p`` (terms up to ~|c|^2 = 200 here cancel, a few float32
ulps) and the port as a direct sum of squares. Winners must be equal
wherever the best and second-best d2 (float64 oracle) differ by more than
1e-3; payloads wherever winners are equal.
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


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2048, 2000, 16384])
def test_kernel_matches_plain_on_the_card(P):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator().manual_seed(P)
    B, dims = 4, (32, 32, 32)
    ip = torch.rand(B, P, 3, generator=g) * 36 - 2
    ip[0, :100, 1] = float("nan")
    valid = torch.rand(B, P, generator=g) > 0.2
    valid[-1] = False
    payload = torch.randint(0, 1 << 14, (B, P), generator=g,
                            dtype=torch.int32)
    args = [t.cuda() for t in (ip, valid, payload)]
    before = md.min_dist_voxels.launches
    out = md.min_dist_voxels(*args, dims)
    torch.cuda.synchronize()
    assert md.min_dist_voxels.launches == before + 1
    ref = md.min_dist_voxels_plain(*args, dims)
    # identical arithmetic (no FMA contraction): bit-equal results
    for x, y in zip(out, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
