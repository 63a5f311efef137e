"""The port's MoveIt binding against ``morefusion_tpu.runtime.moveit_robot``:
the four cases of ``runtime_tests/test_moveit_robot.py`` (request wire
fields, routing of moves, suction and home, the Arduino byte protocol, the
pressure probe) through both packages with fake transports. Wire fields
identical."""

import numpy as np
import pytest
import torch

from morefusion_tpu import runtime as JR
from morefusion_tpu.geometry.transform import quaternion_matrix_np
from morefusion_tpu.runtime import moveit_robot as JM
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch.runtime import moveit_robot as TM

torch.set_num_threads(2)


class FakeTransport:
    def __init__(self, results=None):
        self.calls = []
        self.results = list(results or [])

    def _pop(self):
        return self.results.pop(0) if self.results else True

    def move_to_pose(self, req):
        self.calls.append(("pose", req))
        return self._pop()

    def move_to_joint_position(self, joints, speed):
        self.calls.append(("joints", tuple(joints), speed))
        return self._pop()

    def set_suction(self, on):
        self.calls.append(("suction", on))
        return True


class FakePort:
    def __init__(self):
        self.written = b""

    def write(self, data):
        self.written += data


def _pose(x, y, z, R=None):
    T = np.eye(4)
    if R is not None:
        T[:3, :3] = R
    T[:3, 3] = [x, y, z]
    return T


def _rotations():
    rng = np.random.RandomState(0)
    out = [None, quaternion_matrix_np(np.array([0.5, 0.5, 0.5, 0.5]))[:3, :3]]
    out += [quaternion_matrix_np(rng.randn(4))[:3, :3] for _ in range(8)]
    return out


@pytest.mark.parametrize("speed", [0.3, 1.0, 7.0, 0.0])
def test_build_move_request_wire_fields(speed):
    for k, R in enumerate(_rotations()):
        T = _pose(0.4, -0.1, 0.3 + k / 10, R)
        for kw in (dict(), dict(position_tolerance=0.002,
                                orientation_tolerance=0.1, link_name="ee",
                                avoid_collisions=False)):
            want = JR.build_move_request(T, speed=speed, **kw)
            got = TR.build_move_request(T, speed=speed, **kw)
            assert got == want
            assert type(got["velocity_scaling"]) is float


def _routed(R, results):
    t = FakeTransport(results=results)
    robot = R.MoveItRobotInterface(transport=t, home_pose="overlook")
    out = [robot.move_to(_pose(0.5, 0.0, 0.2), speed=0.3),
           robot.move_to(_pose(0.9, 0.0, 0.2))]
    robot.set_suction(True)
    robot.set_suction(False)
    out += [robot.check_grasped(), robot.home()]
    return out, t.calls


def test_interface_routes_moves_suction_and_home():
    assert TR.JOINT_POSITIONS == JR.JOINT_POSITIONS
    want = _routed(JR, [True, False])
    got = _routed(TR, [True, False])
    assert got == want
    assert got[1][-1] == ("joints", TR.JOINT_POSITIONS["overlook"], 0.9)


def test_serial_suction_speaks_arduino_protocol():
    written = []
    for R in (JR, TR):
        port = FakePort()
        robot = R.MoveItRobotInterface(transport=FakeTransport(),
                                       suction=R.SerialSuction(port))
        for on in (True, False, True, True):
            robot.set_suction(on)
        written.append(port.written)
    assert written[1] == written[0] == b"gsgg"
    assert (TR.SerialSuction.ON, TR.SerialSuction.OFF) == (b"g", b"s")


def test_pressure_sensor_gates_check_grasped():
    seen = []
    for R in (JR, TR):
        class SensedSuction(R.SerialSuction):
            ok = False

            def pressure_ok(self):
                return self.ok

        suction = SensedSuction(FakePort())
        robot = R.MoveItRobotInterface(transport=FakeTransport(),
                                       suction=suction)
        out = [robot.check_grasped()]
        suction.ok = True
        out.append(robot.check_grasped())
        seen.append(out)
    assert seen[1] == seen[0] == [False, True]
    # rospy is looked for only when asked
    assert TM.available() == JM.available()
