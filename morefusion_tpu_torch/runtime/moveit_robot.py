"""Hardware binding: ``RobotInterface`` against the reference's robot
services (optional, requires rospy / a serial port).

Own copy of ``morefusion_tpu/runtime/moveit_robot.py``; ``rospy`` and the
service types are imported inside the functions that use them.

The reference drives a Franka Panda through three transports:

- ``/move_to_pose`` — MoveIt planning + execution service
  (``ros/src/morefusion_ros_panda/src/pose_service.cpp:74-190``,
  ``srv/MoveToPose.srv``: goal_poses + per-goal position/orientation
  tolerance vectors + velocity/acceleration scaling);
- ``/move_to_joint_position`` — taught joint poses
  (``ri/contrib/robot_interface2.py:57-72``, reset/overlook constants);
- ``/set_suction`` — relay service, ultimately an Arduino reading
  ``'g'``/``'s'`` bytes at 9600 baud
  (``arduino/suction_controller.ino``).

Here the same wire contract is split from the logic so everything above
the transport is testable without ROS: request *construction*
(``build_move_request``) is pure, and ``MoveItRobotInterface`` talks to
a ``transport`` object — ``RosServiceTransport`` (import-gated rospy
glue), ``SerialSuction`` (speaks the Arduino byte protocol directly
over any file-like port), or a test fake. Import of this module never
touches ROS.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..geometry.transform import quaternion_from_matrix
from .robot import RobotInterface

#: Taught joint configurations of the reference's Panda cell
#: (``ri/contrib/robot_interface2.py:17-36`` — robot calibration
#: constants; reproduced verbatim because they are data, not code).
JOINT_POSITIONS = {
    "reset": (
        0.0350888149879746,
        -0.9124876247539854,
        -0.09572808180781056,
        -2.040543374092091,
        -0.1354376670387056,
        1.1432695249186622,
        0.7123907900742359,
    ),
    "overlook": (
        0.0049455467613561555,
        0.20376276994262754,
        0.008827571982877296,
        -1.021473878492389,
        0.02799238988916705,
        1.246361540502972,
        0.7944748621281127,
    ),
}


def available() -> bool:
    try:
        import rospy  # noqa: F401

        return True
    except ImportError:
        return False


def build_move_request(
    T_ee2world: np.ndarray,
    speed: float = 1.0,
    position_tolerance: float = 0.01,
    orientation_tolerance: float = 0.05,
    link_name: str = "panda_suction_cup",
    avoid_collisions: bool = True,
) -> dict:
    """MoveToPose.srv request as plain primitives (testable without
    ROS; ``RosServiceTransport`` converts to geometry_msgs). Quaternion
    order is x, y, z, w — the ROS wire convention."""
    T = np.asarray(T_ee2world, np.float64)
    w, x, y, z = quaternion_from_matrix(T)
    speed = float(np.clip(speed, 1e-3, 1.0))
    return dict(
        goal_poses=[
            dict(
                position=tuple(float(v) for v in T[:3, 3]),
                orientation=(float(x), float(y), float(z), float(w)),
            )
        ],
        position_constraints=[(position_tolerance,) * 3],
        orientation_constraints=[(orientation_tolerance,) * 3],
        link_name=link_name,
        velocity_scaling=speed,
        acceleration_scaling=speed,
        pure_translation=False,
        pure_rotation=False,
        avoid_collisions=bool(avoid_collisions),
    )


class SerialSuction:
    """Suction transport speaking the Arduino protocol directly
    (``suction_controller.ino``: ``'g'`` = relay on, ``'s'`` = off).

    ``port`` is any object with ``write(bytes)`` — an opened
    ``serial.Serial`` / file descriptor wrapper on hardware, a
    recording fake in tests. ``open_port`` opens the device node
    without pyserial (raw termios, 9600 8N1)."""

    ON, OFF = b"g", b"s"

    def __init__(self, port):
        self._port = port

    def set_suction(self, on: bool) -> bool:
        self._port.write(self.ON if on else self.OFF)
        if hasattr(self._port, "flush"):
            self._port.flush()
        return True

    @staticmethod
    def open_port(device: str = "/dev/ttyUSB0"):
        import termios

        f = open(device, "wb", buffering=0)
        attrs = termios.tcgetattr(f.fileno())
        attrs[4] = attrs[5] = termios.B9600  # ispeed, ospeed
        termios.tcsetattr(f.fileno(), termios.TCSANOW, attrs)
        return f


class RosServiceTransport:
    """rospy glue: dict requests -> the reference's srv calls."""

    def __init__(
        self,
        move_to_pose: str = "/pose_service/move_to_pose",
        move_to_joint_position: str = "/move_to_joint_position",
        set_suction: str = "/set_suction",
    ):
        import rospy
        from morefusion_ros.srv import MoveToJointPosition, SetSuction
        from morefusion_ros_panda.srv import MoveToPose

        for name in (move_to_pose, move_to_joint_position, set_suction):
            rospy.wait_for_service(name)
        self._pose = rospy.ServiceProxy(move_to_pose, MoveToPose)
        self._joints = rospy.ServiceProxy(
            move_to_joint_position, MoveToJointPosition
        )
        self._suction = rospy.ServiceProxy(set_suction, SetSuction)

    def move_to_pose(self, req: dict) -> bool:
        from geometry_msgs.msg import Point, Pose, Quaternion, Vector3

        poses = [
            Pose(
                position=Point(*g["position"]),
                orientation=Quaternion(*g["orientation"]),
            )
            for g in req["goal_poses"]
        ]
        res = self._pose(
            goal_poses=poses,
            position_constraints=[
                Vector3(*v) for v in req["position_constraints"]
            ],
            orientation_constraints=[
                Vector3(*v) for v in req["orientation_constraints"]
            ],
            link_name=req["link_name"],
            velocity_scaling=req["velocity_scaling"],
            acceleration_scaling=req["acceleration_scaling"],
            pure_translation=req["pure_translation"],
            pure_rotation=req["pure_rotation"],
            avoid_collisions=req["avoid_collisions"],
        )
        return bool(res.success)

    def move_to_joint_position(
        self, joints: Sequence[float], speed: float
    ) -> bool:
        res = self._joints(list(joints), float(speed), float(speed))
        return bool(res.success)

    def set_suction(self, on: bool) -> bool:
        return bool(self._suction(bool(on)).success)


class MoveItRobotInterface(RobotInterface):
    """``RobotInterface`` over the reference's robot services.

    ``transport`` needs ``move_to_pose(req_dict)``,
    ``move_to_joint_position(joints, speed)`` and ``set_suction(on)``
    (all -> bool); default is ``RosServiceTransport`` (requires rospy).
    A separate ``suction`` transport (e.g. ``SerialSuction``) overrides
    the suction path — the physical cell wires the relay to an Arduino,
    not to MoveIt. ``check_grasped`` consults ``pressure_ok`` when the
    transport exposes it (vacuum-sensor hardening; the reference assumes
    every grip succeeds)."""

    def __init__(
        self,
        transport=None,
        suction=None,
        home_pose: str = "overlook",
        position_tolerance: float = 0.01,
        orientation_tolerance: float = 0.05,
        link_name: str = "panda_suction_cup",
    ):
        self._transport = (
            RosServiceTransport() if transport is None else transport
        )
        self._suction = suction or self._transport
        self._home = JOINT_POSITIONS[home_pose]
        self._pos_tol = float(position_tolerance)
        self._ori_tol = float(orientation_tolerance)
        self._link = link_name

    def move_to(self, T_ee2world: np.ndarray, speed: float = 1.0) -> bool:
        req = build_move_request(
            T_ee2world,
            speed,
            self._pos_tol,
            self._ori_tol,
            self._link,
        )
        return bool(self._transport.move_to_pose(req))

    def set_suction(self, on: bool) -> None:
        self._suction.set_suction(bool(on))

    def check_grasped(self) -> bool:
        probe = getattr(self._suction, "pressure_ok", None)
        return bool(probe()) if callable(probe) else True

    def home(self) -> bool:
        return bool(
            self._transport.move_to_joint_position(self._home, 0.9)
        )
