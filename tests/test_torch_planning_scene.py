"""The port's planning scene against ``morefusion_tpu.runtime.
planning_scene``: each case of ``runtime_tests/test_planning_scene.py``
through both packages, then ``clearance`` and ``plan_motion`` on 50
seeded random poses near a scene of four objects, also with a carried
object and static occupancy. Clearances within 1e-12 (float64 NumPy on
both sides); decisions, attached objects and waypoints identical."""

import numpy as np
import pytest
import torch

from morefusion_tpu import runtime as JR
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu.geometry.transform import quaternion_matrix_np
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch.datasets import ProceduralModels as TModels

torch.set_num_threads(2)

ATOL = 1e-12


def _pose(x, y, z):
    T = np.eye(4)
    T[:3, 3] = [x, y, z]
    return T


def _ids(scene):
    return sorted(o.instance_id for o in scene.world_objects())


def _world(scene):
    return [(o.instance_id, o.class_id, o.T_cad2world)
            for o in scene.world_objects()]


def case_lifecycle(R, Models):
    scene = R.PlanningScene(Models())
    out = []
    scene.add_object(7, 1, _pose(0.3, 0.0, 0.05))
    scene.add_object(7, 1, _pose(0.4, 0.0, 0.05))
    out.append(_world(scene))
    scene.attach(7, _pose(0.4, 0.0, 0.10))
    out += [_world(scene), scene.attached_instance]
    out += [scene.detach(_pose(0.1, 0.2, 0.10)), _world(scene)]
    scene.attach(7, _pose(0.1, 0.2, 0.10))
    out += [scene.detach(None), _world(scene), scene.detach(None)]
    scene.remove_object(7)
    return out


def case_clearance(R, Models):
    scene = R.PlanningScene(Models(), ee_radius=0.0)
    scene.add_object(1, 1, _pose(0.0, 0.0, 0.0))
    out = [scene.clearance(_pose(1.0, 0.0, 0.0)),
           scene.clearance(_pose(0.0, 0.0, 0.0)),
           scene.clearance(_pose(1.0, 0.0, 0.0), ignore=(1,))]
    scene2 = R.PlanningScene(Models(), ee_radius=0.0)
    scene2.set_static_occupancy(np.array([[0.5, 0.0, 0.0]]), pitch=0.02)
    out.append(scene2.clearance(_pose(0.0, 0.0, 0.0)))
    return out


def case_lift_over(R, Models):
    scene = R.PlanningScene(Models(), ee_radius=0.01, min_clearance=0.005)
    scene.add_object(1, 1, _pose(0.5, 0.0, 0.0))
    a, b = _pose(0.0, 0.0, 0.0), _pose(1.0, 0.0, 0.0)
    out = [scene.check_motion(a, b), scene.plan_motion(a, b)]
    scene.remove_object(1)
    return out + [scene.plan_motion(a, b)]


def case_goal_contact(R, Models):
    scene = R.PlanningScene(Models(), ee_radius=0.01, min_clearance=0.005)
    scene.add_object(1, 1, _pose(0.5, 0.0, 0.0))
    scene.add_object(2, 2, _pose(0.25, 0.0, 0.0))
    start = _pose(0.0, 0.0, 0.0)
    return [scene._goal_contact_ignores(_pose(0.5, 0.0, 0.0)),
            scene.plan_motion(start, _pose(0.5, 0.0, 0.0)),
            scene.plan_motion(start, _pose(0.25, 0.0, 0.0)),
            scene.plan_motion(start, _pose(1.0, 0, 0), max_lift=0.0)]


def case_robot_cycle(R, Models):
    scene = R.PlanningScene(Models(), ee_radius=0.01, min_clearance=0.005)
    scene.add_object(3, 1, _pose(0.5, 0.0, 0.0))
    scene.add_object(4, 2, _pose(0.25, 0.0, 0.0))
    inner = R.SimulatedRobotInterface()
    robot = R.CollisionAwareRobot(inner, scene, T_home=_pose(0.0, 0.0, 0.0))
    out = [robot.move_to(_pose(0.5, 0.0, 0.0))]
    robot.set_suction(True)
    out += [scene.attached_instance, _ids(scene)]
    out.append(robot.move_to(_pose(0.0, 0.0, 0.0)))
    robot.set_suction(False)
    out += [scene.attached_instance, _world(scene), robot.home(),
            robot.current_pose, inner.log]
    return out


def case_update_from_poses(R, Models):
    scene = R.PlanningScene(Models())
    scene.add_object(1, 1, _pose(0.5, 0.0, 0.0))
    scene.attach(1, _pose(0.5, 0.0, 0.1))
    scene.update_from_poses({
        1: dict(class_id=1, T_cad2world=_pose(0.5, 0.0, 0.0)),
        2: dict(class_id=2, T_cad2world=_pose(0.2, 0.0, 0.0))})
    return [_world(scene), scene.attached_instance]


def case_surface_fallback(R, Models):
    """A bank without solid grids: the surface cloud, padded."""
    bank = Models()

    class SurfaceOnly:
        get_pcd = bank.get_pcd

        def get_solid_voxel_grid(self, class_id):
            raise NotImplementedError

    scene = R.PlanningScene(SurfaceOnly(), max_points=64)
    scene.add_object(1, 3, _pose(0.2, 0.1, 0.0))
    return [scene._body(3), scene.clearance(_pose(0.3, 0.1, 0.05))]


CASES = {f.__name__[5:]: f for f in (
    case_lifecycle, case_clearance, case_lift_over, case_goal_contact,
    case_robot_cycle, case_update_from_poses, case_surface_fallback)}


def _same(got, want, where="out"):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape, where
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=where)
    elif isinstance(want, float):
        assert got == want or abs(got - want) <= ATOL, (where, got, want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{k}]")
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_planning_scene_case(case):
    _same(CASES[case](TR, TModels), CASES[case](JR, JModels))


def _near_poses(scene_poses, n, seed):
    """``n`` seeded poses within 0.15 m of the scene's objects, random
    orientations."""
    rng = np.random.RandomState(seed)
    centres = np.stack([T[:3, 3] for _, T in scene_poses])
    out = []
    for _ in range(n):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        T = np.eye(4)
        T[:3, :3] = quaternion_matrix_np(q)[:3, :3]
        T[:3, 3] = centres[rng.randint(len(centres))] + rng.uniform(
            -0.15, 0.15, 3) * [1, 1, 0.5] + [0, 0, 0.05]
        out.append(T)
    return out


SCENE = [(1, 21, _pose(0.0, 0.0, 0.025)), (2, 16, _pose(0.12, 0.0, 0.04)),
         (3, 5, _pose(-0.1, 0.1, 0.03)), (4, 2, _pose(0.05, -0.12, 0.03))]


def _scene(R, Models, carried, static):
    scene = R.PlanningScene(Models(), ee_radius=0.02, min_clearance=0.01)
    for ins_id, class_id, T in SCENE:
        scene.add_object(ins_id, class_id, T)
    if carried:  # object 4 on the tool, 5 cm below it
        scene.attach(4, SCENE[3][2] @ _pose(0.0, 0.0, 0.05))
    if static:
        scene.set_static_occupancy(
            np.random.RandomState(9).uniform(-0.2, 0.2, (30, 3)) * [1, 1, 0.1],
            pitch=0.01)
    return scene


@pytest.mark.parametrize("carried,static", [(False, False), (True, False),
                                            (False, True)],
                         ids=["free", "carrying", "occupancy"])
def test_random_poses(carried, static):
    """Clearance at 50 seeded poses near the objects, and a motion plan
    between consecutive ones (also with the goal's contact ignore)."""
    poses = _near_poses([(i, T) for i, _, T in SCENE], 50, 11)
    jscene = _scene(JR, JModels, carried, static)
    tscene = _scene(TR, TModels, carried, static)
    decisions = []
    for k, T in enumerate(poses):
        for ignore in ((), (1,)):
            want = jscene.clearance(T, ignore)
            got = tscene.clearance(T, ignore)
            assert abs(got - want) <= ATOL, (k, got, want)
            decisions.append(want >= jscene.min_clearance)
    for k in range(0, len(poses) - 1, 2 if carried or static else 1):
        a, b = poses[k], poses[k + 1]
        _same(tscene.check_motion(a, b), jscene.check_motion(a, b),
              f"check {k}")
        _same(tscene.plan_motion(a, b, max_lift=0.2),
              jscene.plan_motion(a, b, max_lift=0.2), f"plan {k}")
    # both decisions occur
    assert 0 < sum(decisions) < len(decisions)
