"""The port's trajectory execution against ``morefusion_tpu.runtime.
trajectory_exec``: each case of ``runtime_tests/test_trajectory_exec.py``
through both packages, profiles, interpolated poses and executor paths
within 1e-12 (float64 NumPy on both sides)."""

import numpy as np
import pytest
import torch

from morefusion_tpu.geometry.transform import quaternion_matrix_np
from morefusion_tpu.runtime import SimulatedRobotInterface as JRobot
from morefusion_tpu.runtime import trajectory_exec as J
from morefusion_tpu_torch.runtime import SimulatedRobotInterface as TRobot
from morefusion_tpu_torch.runtime import trajectory_exec as T

torch.set_num_threads(2)

ATOL = 1e-12


def _path(points):
    out = []
    for p in points:
        M = np.eye(4)
        M[:3, 3] = p
        out.append(M)
    return np.stack(out)


def _rotated_path():
    T0 = np.eye(4)
    T1 = np.eye(4)
    T1[:3, :3] = quaternion_matrix_np(
        np.array([np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)]))[:3, :3]
    T1[:3, 3] = [0.2, 0, 0]
    return np.stack([T0, T1])


PROFILES = {
    "trapezoidal": (_path([[0, 0, 0], [0.5, 0, 0], [1.0, 0, 0]]), 0.25, 0.5),
    "triangular": (_path([[0, 0, 0], [0.1, 0, 0]]), 0.25, 0.5),
    "velocity_limit": (_path(np.linspace([0, 0, 0], [1.0, 0, 0], 21)), 0.25,
                       0.5),
    "rotation": (_rotated_path(), 0.1, 0.5),
    "positions": (np.random.RandomState(0).rand(7, 3), 0.3, 0.7),
    "at_rest": (_path([[0.1, 0.2, 0.3]] * 3), 0.25, 0.5),
}


@pytest.mark.parametrize("case", sorted(PROFILES))
def test_time_parameterize(case):
    wp, v, a = PROFILES[case]
    want = J.time_parameterize(wp, v_max=v, a_max=a)
    got = T.time_parameterize(wp, v_max=v, a_max=a)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_interpolate_pose():
    wp = _rotated_path()
    times = J.time_parameterize(wp, v_max=0.1, a_max=0.5)
    # the ends, beyond them, the midpoint and seeded times between
    ts = [0.0, -1.0, times[-1], times[-1] + 1.0, times[-1] / 2]
    ts += list(np.random.RandomState(1).uniform(0, times[-1], 20))
    for t in ts:
        np.testing.assert_allclose(T.interpolate_pose(wp, times, t),
                                   J.interpolate_pose(wp, times, t),
                                   atol=ATOL, rtol=0, err_msg=str(t))
    # both slerp branches: nearly parallel (lerp) and the opposite arc
    rng = np.random.RandomState(2)
    for q0, q1 in [(np.array([1.0, 0, 0, 0]), np.array([0.9999, 0.01, 0, 0])),
                   (np.array([1.0, 0, 0, 0]), np.array([-0.5, 0.5, 0.5, 0.5])),
                   (rng.randn(4), rng.randn(4))]:
        for u in (0.0, 0.3, 1.0):
            np.testing.assert_allclose(T._slerp(q0, q1, u),
                                       J._slerp(q0, q1, u), atol=ATOL,
                                       rtol=0)


def test_filter_place_poses():
    down = np.eye(4)
    down[:3, :3] = np.diag([1, -1, -1])
    rng = np.random.RandomState(3)
    poses = [down, np.eye(4)]
    for _ in range(20):
        M = np.eye(4)
        M[:3, :3] = quaternion_matrix_np(rng.randn(4))[:3, :3]
        poses.append(M)
    for limit in (np.deg2rad(30), np.deg2rad(90)):
        want = J.filter_place_poses(poses, limit)
        got = T.filter_place_poses(poses, limit)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _executed(module, robot_cls, wp, rate, move_results=None, **kw):
    robot = robot_cls(move_results=move_results)
    ok = module.TrajectoryExecutor(robot, rate_hz=rate).execute(wp, **kw)
    return ok, robot.log


@pytest.mark.parametrize("case", ["steps", "aborts", "single", "speed"])
def test_executor(case):
    wp = _path([[0, 0, 0.2], [0.1, 0, 0.2], [0.2, 0, 0.3]])
    kw, moves = dict(), None
    if case == "aborts":
        wp, moves = _path([[0, 0, 0], [0.5, 0, 0]]), [True, True, False]
    elif case == "single":
        wp = wp[1]
    elif case == "speed":
        kw = dict(speed=0.4)
    ok_j, log_j = _executed(J, JRobot, wp, 10.0, moves, **kw)
    ok_t, log_t = _executed(T, TRobot, wp, 10.0, moves, **kw)
    assert ok_t == ok_j == (case != "aborts")
    assert len(log_t) == len(log_j) > 0
    for g, w in zip(log_t, log_j):
        assert g[0] == w[0] and g[2:] == w[2:]
        np.testing.assert_allclose(g[1], w[1], atol=ATOL, rtol=0)
