"""The port's pick-and-place state machine and planner execution against
``morefusion_tpu.runtime``: the six scenarios of
``runtime_tests/test_pick_state_machine.py`` (happy path, grasp retries,
persistent grasp failure, unreachable poses, a failed placement) and
``test_robot.py``'s plan and execute, each through both packages, plain
and behind the collision-aware robot. Outcomes, scene-provider calls and
the recorded ``move_to`` / ``set_suction`` sequence are identical, poses
within 1e-12."""

import numpy as np
import pytest
import torch

from morefusion_tpu import geometry as JG
from morefusion_tpu import runtime as JR
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch.datasets import ProceduralModels as TModels

torch.set_num_threads(2)

ATOL = 1e-12


def _pose(t):
    T = np.eye(4)
    T[:3, 3] = t
    return T


def _scene_provider():
    """Two stacked boxes (9 occludes 5 from this camera) + scan counter,
    as ``test_pick_state_machine.py``."""
    T0, T1 = _pose([0.0, 0.0, 0.025]), _pose([0.02, 0.0, 0.09])
    calls = {"n": 0}

    def provider():
        calls["n"] += 1
        return dict(
            poses={5: dict(class_id=21, T_cad2world=T0.copy()),
                   9: dict(class_id=16, T_cad2world=T1.copy())},
            K=np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]]),
            T_cam2world=JG.look_at([0.0, -0.05, 0.7], [0.01, 0, 0]),
            image_shape=(240, 320),
            place_poses={5: _pose([0.3, 0.3, 0.05]),
                         9: _pose([0.3, 0.4, 0.05])})

    provider.calls = calls
    return provider


SCENARIOS = {
    "happy_path": (dict(), dict()),
    "grasp_retries": (dict(grasp_results=[False, False, True]), dict()),
    "persistent_grasp_failure": (dict(grasp_results=[False] * 3),
                                 dict(max_grasp_attempts=3)),
    "unreachable": (dict(move_results=[False] * 50),
                    dict(max_grasp_attempts=2)),
    "place_failure": (dict(move_results=[True, True, True, False]), dict()),
    "rescan_every_attempt": (dict(grasp_results=[False, True]),
                             dict(rescan_after_attempt=0)),
}


def _run(R, Models, scenario, collision_aware):
    robot_kw, machine_kw = SCENARIOS[scenario]
    provider = _scene_provider()
    inner = R.SimulatedRobotInterface(**robot_kw)
    robot = inner
    if collision_aware:
        scene = R.PlanningScene(Models(), ee_radius=0.01,
                                min_clearance=0.005)
        scene.update_from_poses(provider()["poses"])
        provider.calls["n"] = 0
        robot = R.CollisionAwareRobot(inner, scene,
                                      T_home=_pose([0.0, 0.0, 0.5]))
    sm = R.PickAndPlaceStateMachine(
        R.PickAndPlacePlanner(Models()), robot, provider, target_instance=5,
        **machine_kw)
    outcomes = [(o.instance_id, o.status, o.grasp_attempts, o.rescans)
                for o in sm.run()]
    return outcomes, provider.calls["n"], inner.log


def _same_log(got, want):
    assert [e[0] for e in got] == [e[0] for e in want]
    for g, w in zip(got, want):
        if g[0] == "move_to":
            np.testing.assert_allclose(g[1], w[1], atol=ATOL, rtol=0)
            assert g[2:] == w[2:]
        else:
            assert g == w


@pytest.mark.parametrize("collision_aware", [False, True],
                         ids=["plain", "collision_aware"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_state_machine(scenario, collision_aware):
    want = _run(JR, JModels, scenario, collision_aware)
    got = _run(TR, TModels, scenario, collision_aware)
    assert got[0] == want[0] and got[1] == want[1]
    _same_log(got[2], want[2])
    # the scenario test's own checks, on the port (behind the planning
    # scene the grasp reach and the lift out of the sunk grasp decide)
    outcomes = got[0]
    if collision_aware:
        return
    if scenario == "happy_path":
        assert [o[:2] for o in outcomes] == [(9, "placed"), (5, "placed")]
    elif scenario == "persistent_grasp_failure":
        assert dict((o[0], o[1]) for o in outcomes)[9] == "skipped"
    elif scenario == "unreachable":
        assert all(o[1] == "skipped" and o[3] >= 1 for o in outcomes)
    elif scenario == "place_failure":
        assert [o[1] for o in outcomes] == ["dropped", "placed"]


def test_plan_and_execute():
    """``test_robot.py``'s two boxes: the plan executed through the
    simulated adapter, the same commands in both packages."""
    poses = {5: dict(class_id=21, T_cad2world=_pose([0.0, 0.0, 0.025])),
             9: dict(class_id=16, T_cad2world=_pose([0.12, 0.0, 0.04]))}
    T_cam = JG.look_at([0.0, -0.4, 0.6], [0.05, 0, 0])
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])
    logs, oks, plans = [], [], []
    for R, Models, moves in [(JR, JModels, None), (TR, TModels, None),
                             (JR, JModels, [True, False]),
                             (TR, TModels, [True, False])]:
        plan = R.PickAndPlacePlanner(Models()).plan_picks(
            poses, K, T_cam, (240, 320), target_instance=5,
            place_poses={9: _pose([0.3, 0.3, 0.05])})
        robot = R.SimulatedRobotInterface(move_results=moves)
        oks.append(R.PickAndPlacePlanner(Models()).execute(plan, robot))
        plans.append(plan)
        logs.append(robot.log)
    assert oks == [True, True, False, False]
    _same_log(logs[1], logs[0])
    _same_log(logs[3], logs[2])
    assert [e[0] for e in logs[1]].count("suction") == 2 * len(plans[1])
    assert logs[1][-1] == ("home",)
