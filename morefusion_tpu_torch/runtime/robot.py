"""Pick-and-place planning (layer L11, hardware-agnostic).

Own copy of ``morefusion_tpu/runtime/robot.py`` (host, NumPy).

The reference's robot layer (``ros/src/morefusion_ros/ri/pick_and_place.py``
+ MoveIt C++ services) is a scripted state machine over ROS/MoveIt. Here
the *planning* logic (scan poses, picking order, suction grasps, waypoint
sequences) is a pure library; execution goes through a ``RobotInterface``
adapter — a ROS/MoveIt binding implements ``move_to``/``set_suction``
against hardware, and ``SimulatedRobotInterface`` records the sequence for
tests and dry runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import geometry
from .picking import (
    build_occlusion_graph,
    select_picking_order,
    suction_grasp_pose,
)


@dataclasses.dataclass
class PickAction:
    instance_id: int
    class_id: int
    grasp_pose: np.ndarray  # (4, 4) end-effector pose at contact
    pre_grasp_pose: np.ndarray  # approach waypoint
    lift_pose: np.ndarray  # post-grasp retreat
    place_pose: Optional[np.ndarray] = None


class RobotInterface:
    """Execution adapter contract (ROS/MoveIt binding or simulator)."""

    def move_to(self, T_ee2world: np.ndarray, speed: float = 1.0) -> bool:
        raise NotImplementedError

    def set_suction(self, on: bool) -> None:
        raise NotImplementedError

    def check_grasped(self) -> bool:
        """Vacuum-seal check after suction-on (hardening beyond the
        reference, which assumes every grip succeeds — its only guard is
        a raise on impossible placement, ``ri/pick_and_place.py:736``).
        Hardware adapters read the ejector's pressure sensor; defaults to
        True for adapters without one."""
        return True

    def home(self) -> bool:
        raise NotImplementedError


class SimulatedRobotInterface(RobotInterface):
    """Records commands; succeeds unless failures are injected.

    ``grasp_results`` / ``move_results`` are FIFO scripts of booleans the
    next ``check_grasped`` / ``move_to`` calls pop (empty -> success) —
    the fault-injection hooks used by the state-machine scenario tests.
    """

    def __init__(self, grasp_results=None, move_results=None):
        self.log: List = []
        self.grasp_results: List[bool] = list(grasp_results or [])
        self.move_results: List[bool] = list(move_results or [])

    def move_to(self, T_ee2world, speed=1.0):
        ok = self.move_results.pop(0) if self.move_results else True
        self.log.append(("move_to", np.asarray(T_ee2world), speed, ok))
        return ok

    def set_suction(self, on):
        self.log.append(("suction", bool(on)))

    def check_grasped(self):
        ok = self.grasp_results.pop(0) if self.grasp_results else True
        self.log.append(("check_grasped", ok))
        return ok

    def home(self):
        self.log.append(("home",))
        return True


class PickAndPlacePlanner:
    def __init__(
        self,
        models,
        pre_grasp_offset: float = 0.05,
        lift_offset: float = 0.10,
        grasp_overlap: float = 0.01,  # reference ri/pick_and_place.py
    ):
        self._models = models
        self._pre = pre_grasp_offset
        self._lift = lift_offset
        self._overlap = grasp_overlap

    def scan_poses(
        self, n: int = 7, distance=(0.5, 0.7), rng=None
    ) -> np.ndarray:
        """Camera scan poses over the workspace (the reference's scanning
        motion, ``_define_robot_poses``)."""
        rng = rng or np.random.RandomState(0)
        m = n + 1  # trajectory.sort drops the last point (reference quirk)
        eyes = geometry.points_from_angles(
            rng.uniform(*distance, m),
            rng.uniform(45, 80, m),
            np.linspace(-120, 120, m),
        )
        eyes = geometry.trajectory.sort(eyes)
        return np.stack(
            [geometry.look_at(e, np.zeros(3)) for e in eyes]
        )

    def plan_grasp(self, class_id: int, T_cad2world: np.ndarray):
        """Suction grasp for one object at its estimated pose."""
        shape = None
        if hasattr(self._models, "get_shape"):
            shape = self._models.get_shape(class_id)
        pcd = self._models.get_pcd(class_id)
        if shape is not None:
            normals = shape.normals(pcd.astype(np.float64))
        else:  # real meshes: radial normals fallback
            c = pcd.mean(axis=0)
            normals = pcd - c
            normals /= np.linalg.norm(normals, axis=1, keepdims=True) + 1e-12
        R, t = T_cad2world[:3, :3], T_cad2world[:3, 3]
        pts_w = pcd @ R.T + t
        n_w = normals @ R.T
        T = suction_grasp_pose(pts_w, n_w, up=(0, 0, 1))
        if T is None:
            return None
        # sink by the suction overlap (reference grasp_overlap = 1 cm)
        T = T.copy()
        T[:3, 3] += T[:3, 2] * self._overlap
        return T

    def plan_picks(
        self,
        poses: Dict[int, dict],  # instance_id -> {class_id, T_cad2world}
        K: np.ndarray,
        T_cam2world: np.ndarray,
        image_shape,
        target_instance: Optional[int] = None,
        place_poses: Optional[Dict[int, np.ndarray]] = None,
    ) -> List[PickAction]:
        """Occlusion-ordered pick plan reaching the target instance."""
        ids = sorted(poses.keys())
        if not ids:
            return []
        class_ids = [poses[i]["class_id"] for i in ids]
        T_w2c = np.linalg.inv(T_cam2world)
        Ts_cam = [T_w2c @ poses[i]["T_cad2world"] for i in ids]

        occluded_by = build_occlusion_graph(
            self._models, class_ids, Ts_cam, K, image_shape
        )
        target_idx = (
            ids.index(target_instance)
            if target_instance is not None
            else 0
        )
        order = select_picking_order(occluded_by, target_idx)

        plan = []
        for k in order:
            ins_id = ids[k]
            T_cad2world = poses[ins_id]["T_cad2world"]
            grasp = self.plan_grasp(class_ids[k], T_cad2world)
            if grasp is None:
                continue
            pre = grasp.copy()
            pre[:3, 3] -= grasp[:3, 2] * self._pre
            lift = grasp.copy()
            lift[2, 3] += self._lift
            plan.append(
                PickAction(
                    instance_id=ins_id,
                    class_id=class_ids[k],
                    grasp_pose=grasp,
                    pre_grasp_pose=pre,
                    lift_pose=lift,
                    place_pose=(place_poses or {}).get(ins_id),
                )
            )
        return plan

    def execute(
        self, plan: Sequence[PickAction], robot: RobotInterface
    ) -> bool:
        """Run the pick sequence through an adapter (the reference's
        state-machine loop; no retries — see PickAndPlaceStateMachine
        for the failure-hardened loop)."""
        for action in plan:
            if not robot.move_to(action.pre_grasp_pose):
                return False
            if not robot.move_to(action.grasp_pose, speed=0.3):
                return False
            robot.set_suction(True)
            if not robot.move_to(action.lift_pose, speed=0.5):
                return False
            if action.place_pose is not None:
                if not robot.move_to(action.place_pose):
                    return False
            robot.set_suction(False)
        robot.home()
        return True


@dataclasses.dataclass
class PickOutcome:
    instance_id: int
    status: str  # "placed" | "dropped" | "skipped"
    grasp_attempts: int = 0
    rescans: int = 0


class PickAndPlaceStateMachine:
    """Failure-hardened pick-and-place state machine (reference role:
    ``ri/pick_and_place.py:660-768`` main loop, with the retry/re-scan
    branches the reference lacks).

    Per outer iteration, the scene is (re)planned with
    ``PickAndPlacePlanner.plan_picks`` — so an occluded target is
    automatically reached by removing its occluders first (occlusion
    graph, ``select_picking_order``) — and only the FIRST action of the
    plan executes before re-planning, so every pick uses poses that
    reflect what has already been removed.

    Failure handling per pick:
      - unreachable pre-grasp/grasp (``move_to`` False): re-scan the
        scene (fresh poses) and retry; after ``max_grasp_attempts``
        total attempts the object is skipped;
      - vacuum-seal failure (``check_grasped`` False): release, retreat
        to pre-grasp, retry; attempts beyond ``rescan_after_attempt``
        trigger a scene re-scan first (the pose estimate is suspect);
      - placement-motion failure: fall back to the distractor drop
        (mirrors the reference's distractor-box branch instead of its
        hard raise).

    ``scene_provider()`` returns a dict with keys ``poses`` (instance_id
    -> {class_id, T_cad2world}), ``K``, ``T_cam2world``,
    ``image_shape``, and optionally ``place_poses`` — in the live
    system this is a fresh scan through the perception stack
    (``ScenePipeline``); tests use a scripted provider.
    """

    def __init__(
        self,
        planner: PickAndPlacePlanner,
        robot: RobotInterface,
        scene_provider,
        target_instance: Optional[int] = None,
        max_grasp_attempts: int = 3,
        rescan_after_attempt: int = 1,
        max_picks: int = 50,
    ):
        self._planner = planner
        self._robot = robot
        self._scene = scene_provider
        self._target = target_instance
        self._max_attempts = max_grasp_attempts
        self._rescan_after = rescan_after_attempt
        self._max_picks = max_picks
        self.outcomes: List[PickOutcome] = []

    # -- single-pick state machine ---------------------------------------

    def _attempt_pick(self, action: PickAction) -> str:
        """One grasp attempt: approach -> grasp -> suction -> verify ->
        lift. Returns "ok" | "unreachable" | "not_grasped" | "lift_failed"."""
        robot = self._robot
        if not robot.move_to(action.pre_grasp_pose):
            return "unreachable"
        if not robot.move_to(action.grasp_pose, speed=0.3):
            return "unreachable"
        robot.set_suction(True)
        if not robot.check_grasped():
            robot.set_suction(False)
            robot.move_to(action.pre_grasp_pose)  # retreat before retry
            return "not_grasped"
        if not robot.move_to(action.lift_pose, speed=0.5):
            robot.set_suction(False)
            return "lift_failed"
        return "ok"

    def _place_or_drop(self, action: PickAction) -> str:
        """Carry phase: try the place pose, fall back to drop."""
        robot = self._robot
        if action.place_pose is not None and robot.move_to(
            action.place_pose
        ):
            robot.set_suction(False)
            return "placed"
        # distractor-box drop fallback: release where we are (lift pose)
        robot.set_suction(False)
        return "dropped"

    def _plan_next(self, scene, skipped) -> Optional[PickAction]:
        poses = {
            i: p for i, p in scene["poses"].items() if i not in skipped
        }
        if not poses:
            return None
        target = self._target if self._target in poses else None
        plan = self._planner.plan_picks(
            poses,
            scene["K"],
            scene["T_cam2world"],
            scene["image_shape"],
            target_instance=target,
            place_poses=scene.get("place_poses"),
        )
        # leaf-first order: the first action is the least-occluded
        # prerequisite of the target
        return plan[0] if plan else None

    def run(self) -> List[PickOutcome]:
        """Pick until the target is removed (or the scene is empty)."""
        scene = self._scene()
        skipped: set = set()
        for _ in range(self._max_picks):
            action = self._plan_next(scene, skipped)
            if action is None:
                break
            attempts = 0
            rescans = 0
            status = None
            while attempts < self._max_attempts:
                attempts += 1
                result = self._attempt_pick(action)
                if result == "ok":
                    status = self._place_or_drop(action)
                    break
                if attempts >= self._max_attempts:
                    break
                if result == "unreachable" or attempts > self._rescan_after:
                    # pose estimate suspect -> fresh perception pass
                    scene = self._scene()
                    rescans += 1
                    replanned = self._plan_next(scene, skipped)
                    if replanned is not None and (
                        replanned.instance_id == action.instance_id
                    ):
                        action = replanned
            if status is None:
                status = "skipped"
                skipped.add(action.instance_id)
            else:
                scene["poses"].pop(action.instance_id, None)
            self.outcomes.append(
                PickOutcome(
                    instance_id=action.instance_id,
                    status=status,
                    grasp_attempts=attempts,
                    rescans=rescans,
                )
            )
            if action.instance_id == self._target and status != "skipped":
                break
        self._robot.home()
        return self.outcomes
