"""The port's occupancy registration against
``morefusion_tpu.contrib.occupancy_registration``, and
``cli.align_occupancy_grids`` against
``examples/preliminary/align_occupancy_grids.py``.

On the CPU, float32 on both sides: the loss within 1e-6 and its gradients
in (q, t) within 1e-5 of their largest entry, for 2- and 3-channel
targets. Over ``register_occupancy``'s 60 Adam iterations at
``test_occupancy_registration_improves_translation``'s scale (24^3, 800
points of class 21) the losses are held within 1e-5 and the final
(q, t) within 1e-5 on the 2-channel target; on a 3-channel one the run is
chaotic, and past its first 10 iterations the port is held within JAX's
own spread under a 1e-7 m start jitter. The example script's ADD lines
agree within one unit of their fourth decimal (1e-4 m).
"""

import os
import re
import runpy
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu.contrib import occupancy_registration as JR
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu.functions import occupancy_grid_3d as j_occ
from morefusion_tpu_torch import contrib as TC
from morefusion_tpu_torch.cli import align_occupancy_grids as cli
from morefusion_tpu_torch.contrib import occupancy_registration as TR

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 1e-6
GRAD_RTOL = 1e-5
RUN_ATOL = 1e-5
ICC_START_JITTER = 1e-7  # m, as test_torch_pipeline.py jitters ICC
ADD_ATOL = 1e-4 + 1e-9  # one unit of the printed fourth decimal

PITCH = 0.01
DIMS = (24, 24, 24)
ORIGIN = np.array([-0.12, -0.12, -0.12], np.float32)


@pytest.fixture(scope="module")
def problem():
    """The JAX test's problem: 800 CAD points of class 21, their own
    occupancy as the target, a start 2 cm off."""
    pcd = JModels().get_pcd(21)[:800].astype(np.float32)
    occ = np.asarray(j_occ(pcd, pitch=PITCH, origin=ORIGIN, dims=DIMS,
                           threshold=1))
    rng = np.random.RandomState(0)
    empty = (rng.rand(*DIMS) * (occ == 0)).astype(np.float32)
    unknown = (rng.rand(*DIMS) < 0.1).astype(np.float32)
    return dict(pcd=pcd, grid2=np.stack([occ, np.zeros_like(occ)]),
                grid3=np.stack([occ, empty, unknown]))


def _start(seed=1):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=4).astype(np.float32) * 0.05
    q[0] = 1.0
    q = (q / np.linalg.norm(q)).astype(np.float32)
    return q, np.array([0.015, -0.01, 0.012], np.float32)


@pytest.mark.parametrize("channels", [2, 3])
def test_loss_and_gradients_match_jax(problem, channels):
    grid = problem[f"grid{channels}"]
    q, t = _start()
    kw = dict(pitch=PITCH, origin=ORIGIN, threshold=2.0)
    (j_loss, (j_gq, j_gt)) = jax.value_and_grad(
        JR.occupancy_registration_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(problem["pcd"]),
        jnp.asarray(grid), **kw)
    tq = torch.from_numpy(q).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    loss = TR.occupancy_registration_loss(
        tq, tt, torch.from_numpy(problem["pcd"]), torch.from_numpy(grid),
        **dict(kw, origin=torch.from_numpy(ORIGIN)))
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= LOSS_ATOL
    for got, want in ((tq.grad, j_gq), (tt.grad, j_gt)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())


def _register(problem, channels, iterations, trajectory=False):
    q, t = _start()
    kw = dict(pitch=PITCH, threshold=2.0, iterations=iterations, alpha=0.1,
              trajectory=trajectory)
    grid = problem[f"grid{channels}"]
    want = JR.register_occupancy(
        jnp.asarray(problem["pcd"]), jnp.asarray(grid), q, t,
        origin=jnp.asarray(ORIGIN), **kw)
    got = TR.register_occupancy(
        torch.from_numpy(problem["pcd"]), torch.from_numpy(grid),
        torch.from_numpy(q), torch.from_numpy(t),
        origin=torch.from_numpy(ORIGIN), **kw)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def test_register_occupancy_matches_jax(problem):
    """60 iterations from a 2 cm start on the 2-channel target: every
    iteration's loss and the final pose as JAX's."""
    (q, t, losses), (jq, jt, jlosses) = _register(problem, 2, 60)
    assert losses.shape == (60,)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=RUN_ATOL)
    np.testing.assert_allclose(q, jq, rtol=0, atol=RUN_ATOL)
    np.testing.assert_allclose(t, jt, rtol=0, atol=RUN_ATOL)
    # the JAX test's claim holds for the port too
    assert np.linalg.norm(t) < np.linalg.norm(_start()[1])


def test_register_occupancy_within_jax_spread(problem):
    """The 3-channel target (random free and unknown space) makes the run
    chaotic: JAX's own trajectory moves by ~1e-3 m when its start
    translation moves by 1e-7 m. So the port is held to JAX within 1e-5
    over the first ``STRICT`` iterations, and over all 60 (losses,
    quaternions, translations) no farther from JAX than JAX from itself
    under three such start jitters."""
    STRICT = 10
    (qs, ts, losses), (jqs, jts, jlosses) = _register(problem, 3, 60,
                                                      trajectory=True)
    np.testing.assert_allclose(losses[:STRICT], jlosses[:STRICT], rtol=0,
                               atol=RUN_ATOL)
    np.testing.assert_allclose(ts[:STRICT], jts[:STRICT], rtol=0,
                               atol=RUN_ATOL)
    np.testing.assert_allclose(qs[:STRICT], jqs[:STRICT], rtol=0,
                               atol=RUN_ATOL)
    q0, t0 = _start()
    spread = np.zeros(3)
    for seed in range(3):
        t_j = (t0 + np.random.RandomState(10 + seed).normal(
            0, ICC_START_JITTER, 3)).astype(np.float32)
        out = JR.register_occupancy(
            jnp.asarray(problem["pcd"]), jnp.asarray(problem["grid3"]), q0,
            t_j, origin=jnp.asarray(ORIGIN), pitch=PITCH, threshold=2.0,
            iterations=60, alpha=0.1, trajectory=True)
        spread = np.maximum(spread, [
            np.abs(np.asarray(x) - y).max()
            for x, y in zip(out, (jqs, jts, jlosses))])
    err = [np.abs(x - y).max()
           for x, y in zip((qs, ts, losses), (jqs, jts, jlosses))]
    print(f"60 iterations, 3 channels: the port against JAX {err}, JAX "
          f"against itself under the jitter {spread.tolist()}")
    assert spread[1] > RUN_ATOL
    assert (np.asarray(err) <= spread).all(), (err, spread)


def test_trajectory_is_the_stepwise_run(problem):
    """``trajectory=True`` gives each step's parameters of the same run:
    its last row is the plain run's result, and JAX's trajectory."""
    (qs, ts, losses), (jqs, jts, _) = _register(problem, 2, 12,
                                                 trajectory=True)
    assert qs.shape == (12, 4) and ts.shape == (12, 3)
    (q, t, losses_plain), _ = _register(problem, 2, 12)
    np.testing.assert_array_equal(qs[-1], q)
    np.testing.assert_array_equal(ts[-1], t)
    np.testing.assert_array_equal(losses, losses_plain)
    np.testing.assert_allclose(qs, jqs, rtol=0, atol=RUN_ATOL)
    np.testing.assert_allclose(ts, jts, rtol=0, atol=RUN_ATOL)


def test_registration_wrapper(problem):
    """``register_iterative`` yields ``iterations + 1`` transforms, the
    first the start, the last ``register``'s; both as JAX's wrapper."""
    from morefusion_tpu.contrib import OccupancyRegistration as JOR

    from morefusion_tpu_torch.geometry import quaternion_matrix_np

    q0, t0 = _start()
    T0 = quaternion_matrix_np(q0)
    T0[:3, 3] = t0
    kw = dict(pitch=PITCH, origin=ORIGIN, threshold=2.0, transform_init=T0)
    Ts = list(TC.OccupancyRegistration(
        problem["pcd"], problem["grid2"], device="cpu",
        **kw).register_iterative(iteration=10))
    assert len(Ts) == 11
    np.testing.assert_allclose(Ts[0], T0, atol=1e-6)
    T = TC.OccupancyRegistration(problem["pcd"], problem["grid2"],
                                 device="cpu", **kw).register(iteration=10)
    np.testing.assert_array_equal(Ts[-1], T)
    Tj = JOR(problem["pcd"], problem["grid2"], **kw).register(iteration=10)
    np.testing.assert_allclose(T, Tj, atol=RUN_ATOL)
    Tjs = list(JOR(problem["pcd"], problem["grid2"],
                   **kw).register_iterative(iteration=10))
    np.testing.assert_allclose(np.stack(Ts), np.stack(Tjs), atol=RUN_ATOL)


def test_registration_defaults_to_the_card(problem):
    """Without ``device=`` the wrapper goes to CUDA; with no card that
    fails rather than running on the CPU."""
    kw = dict(pitch=PITCH, origin=ORIGIN, threshold=1.0,
              transform_init=np.eye(4))
    if torch.cuda.is_available():
        reg = TC.OccupancyRegistration(problem["pcd"], problem["grid2"], **kw)
        assert reg._points.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TC.OccupancyRegistration(problem["pcd"], problem["grid2"], **kw)


ADD_LINE = re.compile(r"iter\s+(\d+): ADD ([0-9.]+)")


def _add_lines(text):
    return [(int(i), float(a)) for i, a in ADD_LINE.findall(text)]


def test_cli_matches_example(capsys):
    """``cli.align_occupancy_grids`` beside the example at a 16^3 grid and
    20 iterations: the same target and printed iterations, the start's ADD
    equal. With Adam's quaternion rate of 0.1 the run is chaotic on the
    fused grids, so past the start each ADD is held to JAX's, within the
    spread of JAX's own ADDs when the start translation moves by 1e-7 m
    (three jitters), plus one unit of the printed fourth decimal."""
    from morefusion_tpu.contrib import OccupancyRegistration as JOR
    from morefusion_tpu_torch.metrics import average_distance

    argv = ["--voxel-dim", "16", "--iterations", "20"]
    with mock.patch.object(sys, "argv", ["align_occupancy_grids.py"] + argv):
        runpy.run_path(os.path.join(ROOT, "examples", "preliminary",
                                    "align_occupancy_grids.py"),
                       run_name="__main__")
    want = capsys.readouterr().out
    adds = cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]  # the target
    got_l, want_l = _add_lines(got), _add_lines(want)
    assert [i for i, _ in got_l] == [i for i, _ in want_l]
    assert len(got_l) == 11 and len(adds) == 21
    assert got_l[0] == want_l[0]

    # JAX's run on the same problem, and its spread under the jitter
    args = cli.parse_args(argv)
    _, _, T_true, pitch, origin, grids, cad = cli.target_problem(args)
    T_init = cli._perturbed(T_true, np.random.RandomState(args.seed))

    def jax_adds(T0):
        reg = JOR(cad, grids, pitch=pitch, origin=origin, threshold=2.0,
                  transform_init=T0)
        return np.array([average_distance([cad], [T_true], [T])[0][0]
                         for T in reg.register_iterative(iteration=20)])

    j_adds = jax_adds(T_init)
    printed = [i for i, _ in want_l]
    np.testing.assert_allclose(j_adds[printed], [a for _, a in want_l],
                               rtol=0, atol=ADD_ATOL / 2)
    spread = 0.0
    for seed in range(3):
        T0 = T_init.copy()
        T0[:3, 3] += np.random.RandomState(seed).normal(
            0, ICC_START_JITTER, 3)
        spread = max(spread, np.abs(jax_adds(T0) - j_adds).max())
    err = np.abs(np.asarray(adds) - j_adds).max()
    print(f"align_occupancy_grids, 20 iterations: the port's ADD against "
          f"JAX's {err}, JAX against itself under the jitter {spread}")
    assert err <= spread + ADD_ATOL, (err, spread)
