"""The port's picking order and pick planning against ``morefusion_tpu.
runtime``: the occlusion graph on the same renders, the picking order, the
suction grasps, ``scan_poses`` and ``plan_picks`` of both packages on the
scenes of ``runtime_tests/test_robot.py`` and
``test_pick_state_machine.py`` and on a generator scene of six objects.
Graphs and orders identical, poses within 1e-12 (host NumPy on both
sides)."""

import numpy as np
import pytest
import torch

from morefusion_tpu import geometry as JG
from morefusion_tpu import runtime as JR
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu_torch import geometry as TG
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch.datasets import ProceduralModels as TModels
from morefusion_tpu_torch.simulation import PlaneTypeSceneGeneration

torch.set_num_threads(2)

ATOL = 1e-12
K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])
SHAPE = (240, 320)


def _pose(t):
    T = np.eye(4)
    T[:3, 3] = t
    return T


def _generator_scene():
    """Six objects of ``PlaneTypeSceneGeneration(RandomState(5))`` under
    the camera of ``scan_poses``' first view."""
    gen = PlaneTypeSceneGeneration(TModels(), n_object=6,
                                   random_state=np.random.RandomState(5))
    gen.generate()
    poses = {int(i): dict(class_id=int(o["class_id"]),
                          T_cad2world=o["T_cad2world"])
             for i, o in gen.objects.items()}
    T_cam = TR.PickAndPlacePlanner(TModels()).scan_poses(n=7)[0]
    return poses, T_cam


SCENES = {
    "two_boxes": (
        {5: dict(class_id=21, T_cad2world=_pose([0.0, 0.0, 0.025])),
         9: dict(class_id=16, T_cad2world=_pose([0.12, 0.0, 0.04]))},
        JG.look_at([0.0, -0.4, 0.6], [0.05, 0, 0])),
    "stacked": (
        {5: dict(class_id=21, T_cad2world=_pose([0.0, 0.0, 0.025])),
         9: dict(class_id=16, T_cad2world=_pose([0.02, 0.0, 0.09]))},
        JG.look_at([0.0, -0.05, 0.7], [0.01, 0, 0])),
}


@pytest.fixture(scope="module")
def scenes():
    return dict(SCENES, generator=_generator_scene())


def _cam_poses(poses, T_cam2world):
    ids = sorted(poses)
    T_w2c = np.linalg.inv(T_cam2world)
    return ([poses[i]["class_id"] for i in ids],
            [T_w2c @ poses[i]["T_cad2world"] for i in ids])


@pytest.mark.parametrize("name", ["two_boxes", "stacked", "generator"])
def test_occlusion_graph_and_order(scenes, name):
    poses, T_cam = scenes[name]
    class_ids, Ts = _cam_poses(poses, T_cam)
    want = JR.build_occlusion_graph(JModels(), class_ids, Ts, K, SHAPE)
    got = TR.build_occlusion_graph(TModels(), class_ids, Ts, K, SHAPE)
    assert got == want
    for target in range(len(class_ids)):
        assert (TR.select_picking_order(got, target)
                == JR.select_picking_order(want, target))


@pytest.mark.parametrize("graph,target", [
    ({0: {1}, 1: {0}, 2: set()}, 0),  # a cycle, broken greedily
    ({0: {1, 2}, 1: {2}, 2: set(), 3: {0}}, 0),
    ({0: set(), 1: {0}}, 1),
])
def test_picking_order_cases(graph, target):
    assert (TR.select_picking_order(graph, target)
            == JR.select_picking_order(graph, target))


def test_suction_grasp_pose():
    rng = np.random.RandomState(4)
    for up in [(0, 0, -1), (0, 0, 1), (0, 1, 0), (1, 0, 0)]:
        points = rng.randn(50, 3)
        normals = rng.randn(50, 3)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        np.testing.assert_allclose(
            TR.suction_grasp_pose(points, normals, up),
            JR.suction_grasp_pose(points, normals, up), atol=ATOL, rtol=0)
    # the approach along y: the cross product with y vanishes
    n = np.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(
        TR.suction_grasp_pose(np.zeros((1, 3)), n, (0, 1, 0)),
        JR.suction_grasp_pose(np.zeros((1, 3)), n, (0, 1, 0)), atol=ATOL,
        rtol=0)
    assert TR.suction_grasp_pose(np.zeros((0, 3)), np.zeros((0, 3))) is None


@pytest.mark.parametrize("n,seed", [(5, None), (7, None), (7, 3)])
def test_scan_poses(n, seed):
    def rng():
        return None if seed is None else np.random.RandomState(seed)

    want = JR.PickAndPlacePlanner(JModels()).scan_poses(n=n, rng=rng())
    got = TR.PickAndPlacePlanner(TModels()).scan_poses(n=n, rng=rng())
    assert got.shape == want.shape == (n, 4, 4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(TG.look_at([0.1, 0.2, 0.5], np.zeros(3)),
                               JG.look_at([0.1, 0.2, 0.5], np.zeros(3)),
                               atol=ATOL, rtol=0)


def _same_plan(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.instance_id, g.class_id) == (w.instance_id, w.class_id)
        for key in ("grasp_pose", "pre_grasp_pose", "lift_pose",
                    "place_pose"):
            a, b = getattr(g, key), getattr(w, key)
            assert (a is None) == (b is None), key
            if b is not None:
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=0,
                                           err_msg=key)


@pytest.mark.parametrize("name", ["two_boxes", "stacked", "generator"])
def test_plan_picks(scenes, name):
    poses, T_cam = scenes[name]
    ids = sorted(poses)
    places = {ids[0]: _pose([0.3, 0.3, 0.05])}
    for target in (ids[0], ids[-1], None):
        kw = dict(target_instance=target, place_poses=places)
        want = JR.PickAndPlacePlanner(JModels()).plan_picks(
            poses, K, T_cam, SHAPE, **kw)
        got = TR.PickAndPlacePlanner(TModels()).plan_picks(
            poses, K, T_cam, SHAPE, **kw)
        _same_plan(got, want)
    # each class's grasp alone, and the radial-normals fallback of a bank
    # without shapes
    for i in ids:
        c, T = poses[i]["class_id"], poses[i]["T_cad2world"]
        np.testing.assert_allclose(
            TR.PickAndPlacePlanner(TModels()).plan_grasp(c, T),
            JR.PickAndPlacePlanner(JModels()).plan_grasp(c, T), atol=ATOL,
            rtol=0)

    class NoShapes:
        def __init__(self, bank):
            self.get_pcd = bank.get_pcd

    np.testing.assert_allclose(
        TR.PickAndPlacePlanner(NoShapes(TModels())).plan_grasp(c, T),
        JR.PickAndPlacePlanner(NoShapes(JModels())).plan_grasp(c, T),
        atol=ATOL, rtol=0)
