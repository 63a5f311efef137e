"""Waypoint trajectory time-parameterization + execution.

Own copy of ``morefusion_tpu/runtime/trajectory_exec.py`` (host, NumPy,
float64), on the port's ``geometry.transform``.

The reference's MoveIt pose service plans a joint trajectory and
time-parameterizes it with IterativeParabolicTimeParameterization before
execution (``morefusion_ros_panda/src/pose_service.cpp:16,33``); place
poses are filtered by an angle-from-vertical limit before motion
(``ri/pick_and_place.py:211-231``). MoveIt cannot run in this
environment, but the *math* those components contribute is
hardware-agnostic; this module provides it against the
``RobotInterface`` adapter:

- ``time_parameterize``: per-waypoint timestamps from a trapezoidal
  velocity profile over path arc length, honoring velocity and
  acceleration limits (the IPTP role, Cartesian-space);
- ``interpolate_pose``: slerp + lerp between bracketing waypoints;
- ``filter_place_poses``: the angle-from-vertical gate;
- ``TrajectoryExecutor``: steps a parameterized path through
  ``RobotInterface.move_to`` at a fixed control rate.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..geometry.transform import quaternion_from_matrix, quaternion_matrix_np


def time_parameterize(
    waypoints: np.ndarray,
    v_max: float = 0.25,
    a_max: float = 0.5,
) -> np.ndarray:
    """Timestamps for a Cartesian waypoint path under a trapezoidal
    velocity profile.

    Args:
      waypoints: ``(N, 4, 4)`` poses (or ``(N, 3)`` positions).
      v_max: peak speed [m/s]; a_max: accel/decel limit [m/s^2].

    Returns:
      ``(N,)`` monotonically increasing times, ``t[0] == 0``.

    The profile accelerates from rest, cruises at ``v_max`` when the
    path is long enough (otherwise a triangular profile peaks at
    ``sqrt(a_max * L)``), and decelerates to rest — speed is a function
    of arc length, so timestamps come from integrating ``1/v(s)``
    segment-by-segment (closed form per regime).
    """
    wp = np.asarray(waypoints, dtype=np.float64)
    pos = wp[:, :3, 3] if wp.ndim == 3 else wp
    seg = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    L = s[-1]
    if L <= 1e-12:
        return np.zeros(len(pos))

    v_peak = min(v_max, np.sqrt(a_max * L))
    s_acc = v_peak**2 / (2.0 * a_max)  # accel (and decel) distance

    def t_of_s(si):
        if si <= s_acc:  # accelerating: s = a t^2 / 2
            return np.sqrt(2.0 * si / a_max)
        t_acc = v_peak / a_max
        if si <= L - s_acc:  # cruising
            return t_acc + (si - s_acc) / v_peak
        # decelerating: remaining distance r from the end
        r = max(L - si, 0.0)
        t_total = t_acc + (L - 2 * s_acc) / v_peak + t_acc
        return t_total - np.sqrt(2.0 * r / a_max)

    return np.array([t_of_s(si) for si in s])


def _slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:  # shortest arc
        q1, dot = -q1, -dot
    if dot > 0.9995:  # nearly parallel: lerp + renormalize
        q = q0 + u * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    return (
        np.sin((1.0 - u) * theta) * q0 + np.sin(u * theta) * q1
    ) / np.sin(theta)


def interpolate_pose(
    waypoints: np.ndarray, times: np.ndarray, t: float
) -> np.ndarray:
    """Pose at time ``t`` along a parameterized path (slerp + lerp)."""
    wp = np.asarray(waypoints, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    if t <= times[0]:
        return wp[0].copy()
    if t >= times[-1]:
        return wp[-1].copy()
    k = int(np.searchsorted(times, t, side="right")) - 1
    dt = times[k + 1] - times[k]
    u = 0.0 if dt <= 0 else (t - times[k]) / dt
    T = np.eye(4)
    T[:3, 3] = (1 - u) * wp[k, :3, 3] + u * wp[k + 1, :3, 3]
    q = _slerp(
        quaternion_from_matrix(wp[k]), quaternion_from_matrix(wp[k + 1]), u
    )
    T[:3, :3] = quaternion_matrix_np(q)[:3, :3]
    return T


def filter_place_poses(
    poses: Sequence[np.ndarray],
    angle_from_vertical_limit: float = np.deg2rad(30.0),
) -> List[np.ndarray]:
    """Keep poses whose tool z-axis points down within the angle limit
    (reference ``_filter_robot_poses``, ``ri/pick_and_place.py:211-231``)."""
    kept = []
    down = np.array([0.0, 0.0, -1.0])
    for T in poses:
        z_axis = np.asarray(T)[:3, 2]
        cosang = float(
            np.dot(z_axis, down)
            / max(np.linalg.norm(z_axis), 1e-12)
        )
        if np.arccos(np.clip(cosang, -1.0, 1.0)) < angle_from_vertical_limit:
            kept.append(np.asarray(T))
    return kept


class TrajectoryExecutor:
    """Steps a time-parameterized Cartesian path through a
    ``RobotInterface`` at a fixed control rate (the execution half of the
    reference pose service; its planning half is
    ``PickAndPlacePlanner``)."""

    def __init__(
        self,
        robot,
        rate_hz: float = 20.0,
        v_max: float = 0.25,
        a_max: float = 0.5,
    ):
        self._robot = robot
        self._rate = rate_hz
        self._v_max = v_max
        self._a_max = a_max

    def execute(
        self,
        waypoints: np.ndarray,
        speed: float = 1.0,
        times: Optional[np.ndarray] = None,
    ) -> bool:
        """Move through the waypoints; ``speed`` scales the velocity
        limit (matching ``RobotInterface.move_to``'s speed argument).
        Returns False on the first failed motion."""
        wp = np.asarray(waypoints, dtype=np.float64)
        if wp.ndim == 2:  # single pose
            wp = wp[None]
        if len(wp) == 1:
            return self._robot.move_to(wp[0], speed=speed)
        if times is None:
            times = time_parameterize(
                wp, v_max=self._v_max * speed, a_max=self._a_max
            )
        t_end = float(times[-1])
        n_steps = max(int(np.ceil(t_end * self._rate)), 1)
        for i in range(n_steps + 1):
            t = t_end * i / n_steps
            T = interpolate_pose(wp, times, t)
            if not self._robot.move_to(T, speed=speed):
                return False
        return True
