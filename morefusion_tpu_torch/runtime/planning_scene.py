"""Collision world + collision-aware motion gating (layer L11).

Own copy of ``morefusion_tpu/runtime/planning_scene.py``. The clearance
stays float64 NumPy on the host, as JAX computes it: the knn kernel is
fp32, and on the card it would flip decisions near ``min_clearance``.

Reference role: the MoveIt planning-scene service
(``ros/src/morefusion_ros_panda/src/update_scene_service.cpp:25-80``)
plus the pick-and-place program's scene bookkeeping
(``ros/src/morefusion_ros/ri/pick_and_place.py:549-615``): every unpicked
object is attached to the world link, a grasped object re-attaches to the
suction-cup link, a placed object returns to the world at its new pose,
and MoveIt plans collision-free paths against that scene. Here the same
scene lifecycle is a pure library and the path gating is explicit
geometry — point-cloud clearance, swept-segment checks (slerp + lerp via
``trajectory_exec.interpolate_pose``), and a deterministic lift-over
planner — so the full pick-and-place stack is collision-checked without
ROS or MoveIt. ``CollisionAwareRobot`` folds it under the existing
``RobotInterface`` contract, so ``PickAndPlaceStateMachine`` gains
collision awareness unchanged (its "unreachable" branch is exactly a
planning failure).

MoveIt-semantics notes:
- MOVE is ADD with an existing id (MoveIt CollisionObject op semantics).
- The AllowedCollisionMatrix equivalent: a motion whose *goal* touches a
  world object (suction grasps sink 1 cm into the target,
  ``ri/pick_and_place.py`` grasp_overlap) auto-allows contact with the
  single nearest such object for that motion only; every other object
  still blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..geometry.transform import transform_points_np
from .robot import RobotInterface
from .trajectory_exec import interpolate_pose


@dataclasses.dataclass
class SceneObject:
    instance_id: int
    class_id: int
    T_cad2world: np.ndarray  # (4, 4)


class PlanningScene:
    """World of collision objects + an optional attached (carried) object.

    Obstacle geometry is per-class CAD surface points (downsampled once,
    cached) plus optional static occupancy voxel centers from the
    mapping module; the moving body is the suction tool (a sphere of
    ``ee_radius`` at the tool center) plus the attached object's cloud.
    """

    def __init__(
        self,
        models,
        ee_radius: float = 0.04,
        min_clearance: float = 0.01,
        max_points: int = 192,
    ):
        self._models = models
        self.ee_radius = float(ee_radius)
        self.min_clearance = float(min_clearance)
        self._max_points = int(max_points)
        self._pcd_cache: Dict[int, np.ndarray] = {}
        self._world: Dict[int, SceneObject] = {}
        # attached: (instance_id, class_id, T_cad2ee)
        self._attached: Optional[tuple] = None
        self._static_points = np.zeros((0, 3), np.float64)
        self._static_pad = 0.0

    # -- scene lifecycle (update_scene_service.cpp diff semantics) --------

    def add_object(self, instance_id, class_id, T_cad2world):
        """ADD, or MOVE when ``instance_id`` already exists."""
        self._world[int(instance_id)] = SceneObject(
            int(instance_id),
            int(class_id),
            np.asarray(T_cad2world, np.float64),
        )

    def remove_object(self, instance_id):
        self._world.pop(int(instance_id), None)

    def update_from_poses(self, poses: Dict[int, dict]):
        """Rebuild the static world from a perception result
        (``_update_static_scene``: instance_id -> {class_id,
        T_cad2world}); the attached object, if any, stays attached."""
        self._world.clear()
        for ins_id, p in poses.items():
            if self._attached is not None and self._attached[0] == ins_id:
                continue
            self.add_object(ins_id, p["class_id"], p["T_cad2world"])

    def set_static_occupancy(self, points, pitch: float = 0.0):
        """Voxel centers (e.g. ``OccupancyFusion`` map) as obstacles;
        half a diagonal of padding accounts for voxel extent."""
        self._static_points = np.asarray(points, np.float64).reshape(-1, 3)
        self._static_pad = float(pitch) * np.sqrt(3.0) / 2.0

    def attach(self, instance_id, T_ee2world):
        """Grasp: move a world object to the suction-cup link
        (``_update_scene_with_grasp``)."""
        obj = self._world.pop(int(instance_id))
        T_cad2ee = np.linalg.inv(np.asarray(T_ee2world, np.float64)) @ (
            obj.T_cad2world
        )
        self._attached = (obj.instance_id, obj.class_id, T_cad2ee)

    def detach(self, T_ee2world=None):
        """Release. With ``T_ee2world``: placement — the object returns
        to the world at its carried pose (``_update_scene_with_placement``).
        Without: drop — it leaves the scene (``_update_scene_with_drop``).
        Returns the released instance_id (or None)."""
        if self._attached is None:
            return None
        ins_id, class_id, T_cad2ee = self._attached
        self._attached = None
        if T_ee2world is not None:
            self.add_object(
                ins_id,
                class_id,
                np.asarray(T_ee2world, np.float64) @ T_cad2ee,
            )
        return ins_id

    @property
    def attached_instance(self) -> Optional[int]:
        return None if self._attached is None else self._attached[0]

    def world_objects(self) -> List[SceneObject]:
        return list(self._world.values())

    # -- geometry ----------------------------------------------------------

    def _body(self, class_id):
        """(points, pad): solid collision volume of one class — the
        solid voxel grid coarsened to <= max_points centers, padded by
        the coarse half-diagonal so the union of padded spheres covers
        the original solid (surface clouds are hollow: an EE pose inside
        an object must read as collision). Falls back to the surface
        cloud padded by its sampling spacing when no solid grid exists."""
        class_id = int(class_id)
        if class_id not in self._pcd_cache:
            try:
                grid = self._models.get_solid_voxel_grid(class_id)
                pts = np.asarray(grid.points, np.float64)
                s = max(
                    1,
                    int(np.ceil((len(pts) / self._max_points) ** (1 / 3))),
                )
                pitch = grid.pitch * s
                idx = np.floor(
                    (pts - np.asarray(grid.origin)) / pitch
                ).astype(np.int64)
                idx = np.unique(idx, axis=0)
                pts = np.asarray(grid.origin) + (idx + 0.5) * pitch
                pad = pitch * np.sqrt(3.0) / 2.0
            except NotImplementedError:
                pts = np.asarray(self._models.get_pcd(class_id), np.float64)
                if len(pts) > self._max_points:
                    sel = np.random.RandomState(class_id).choice(
                        len(pts), self._max_points, replace=False
                    )
                    pts = pts[sel]
                bbox = pts.max(axis=0) - pts.min(axis=0)
                area = 2.0 * (
                    bbox[0] * bbox[1] + bbox[1] * bbox[2] + bbox[0] * bbox[2]
                )
                pad = float(np.sqrt(area / max(len(pts), 1)))
            self._pcd_cache[class_id] = (pts, float(pad))
        return self._pcd_cache[class_id]

    def _obstacle_sets(self, ignore=()):
        """[(points, pad)] — pad widens point obstacles (voxel extent)."""
        ignore = set(int(i) for i in ignore)
        sets = []
        for obj in self._world.values():
            if obj.instance_id in ignore:
                continue
            pts, pad = self._body(obj.class_id)
            sets.append(
                (transform_points_np(pts, obj.T_cad2world), pad)
            )
        if len(self._static_points):
            sets.append((self._static_points, self._static_pad))
        return sets

    def _moving_points(self, T_ee2world):
        """[(points, pad)] for the EE sphere + attached object cloud."""
        T = np.asarray(T_ee2world, np.float64)
        sets = [(T[:3, 3].reshape(1, 3), self.ee_radius)]
        if self._attached is not None:
            _, class_id, T_cad2ee = self._attached
            pts, pad = self._body(class_id)
            sets.append(
                (transform_points_np(pts, T @ T_cad2ee), pad)
            )
        return sets

    def clearance(self, T_ee2world, ignore=()) -> float:
        """Min distance from the moving body (EE + attached object) to
        the scene, minus body/obstacle padding. Negative = collision."""
        obstacles = self._obstacle_sets(ignore)
        if not obstacles:
            return np.inf
        best = np.inf
        for mp, mpad in self._moving_points(T_ee2world):
            for op, opad in obstacles:
                d2 = (
                    np.sum(mp * mp, axis=1)[:, None]
                    + np.sum(op * op, axis=1)[None, :]
                    - 2.0 * (mp @ op.T)
                )
                d = np.sqrt(max(float(d2.min()), 0.0)) - mpad - opad
                best = min(best, d)
        return best

    # -- motion gating -------------------------------------------------------

    def check_motion(self, T_a, T_b, ignore=(), step: float = 0.02):
        """Swept check of the slerp+lerp motion from ``T_a`` to ``T_b``
        at ~``step``-meter translation resolution. Returns (ok,
        min_clearance_along_path)."""
        T_a = np.asarray(T_a, np.float64)
        T_b = np.asarray(T_b, np.float64)
        dist = float(np.linalg.norm(T_b[:3, 3] - T_a[:3, 3]))
        n = max(2, int(np.ceil(dist / max(step, 1e-6))) + 1)
        wp = np.stack([T_a, T_b])
        times = np.array([0.0, 1.0])
        worst = np.inf
        for u in np.linspace(0.0, 1.0, n):
            c = self.clearance(interpolate_pose(wp, times, u), ignore)
            worst = min(worst, c)
            if worst < self.min_clearance:
                return False, worst
        return True, worst

    def _goal_contact_ignores(self, T_goal, ignore=()):
        """AllowedCollisionMatrix equivalent: if the goal pose itself
        touches exactly the nearest world object (a suction grasp sinks
        into its target), allow contact with that one object."""
        ignore = set(int(i) for i in ignore)
        if self.clearance(T_goal, ignore) >= self.min_clearance:
            return ignore
        best_id, best_d = None, np.inf
        for obj in self._world.values():
            if obj.instance_id in ignore:
                continue
            d = self.clearance(
                T_goal,
                ignore | {o for o in self._world if o != obj.instance_id},
            )
            if d < best_d:
                best_id, best_d = obj.instance_id, d
        if best_id is not None and best_d < self.min_clearance:
            ignore = ignore | {best_id}
        return ignore

    def plan_motion(
        self,
        T_start,
        T_goal,
        ignore=(),
        lift_step: float = 0.05,
        max_lift: float = 0.60,
        step: float = 0.02,
    ) -> Optional[List[np.ndarray]]:
        """Waypoint path from ``T_start`` to ``T_goal``: the straight
        motion if clear, else the lowest clear lift-over (up, across at
        height, down) — the deterministic equivalent of MoveIt's planner
        for a tabletop workspace. None = unreachable within
        ``max_lift``."""
        T_start = np.asarray(T_start, np.float64)
        T_goal = np.asarray(T_goal, np.float64)
        ignore = self._goal_contact_ignores(T_goal, ignore)
        ok, _ = self.check_motion(T_start, T_goal, ignore, step)
        if ok:
            return [T_goal]
        n_lift = int(np.ceil(max_lift / lift_step))
        for k in range(1, n_lift + 1):
            h = k * lift_step
            up = T_start.copy()
            up[2, 3] += h
            across = T_goal.copy()
            across[2, 3] = up[2, 3]
            segs = [(T_start, up), (up, across), (across, T_goal)]
            if all(
                self.check_motion(a, b, ignore, step)[0] for a, b in segs
            ):
                return [up, across, T_goal]
        return None


class CollisionAwareRobot(RobotInterface):
    """Wraps any ``RobotInterface`` with planning-scene gating.

    ``move_to`` plans through the scene (returns False when no
    collision-free path exists — the state machine's "unreachable"
    branch) and executes the waypoints on the inner adapter.
    ``set_suction(True)`` attaches the world object nearest the suction
    cup (within ``grasp_reach``); ``set_suction(False)`` detaches at the
    current pose — placement semantics, matching
    ``_update_scene_with_{grasp,placement}``. Call
    ``scene.remove_object`` afterwards for a distractor-box drop."""

    def __init__(
        self,
        inner: RobotInterface,
        scene: PlanningScene,
        T_home: Optional[np.ndarray] = None,
        grasp_reach: float = 0.08,
    ):
        self._inner = inner
        self.scene = scene
        self._T_home = (
            np.eye(4) if T_home is None else np.asarray(T_home, np.float64)
        )
        self._T_current = self._T_home.copy()
        self._grasp_reach = float(grasp_reach)

    @property
    def current_pose(self) -> np.ndarray:
        return self._T_current.copy()

    def move_to(self, T_ee2world, speed: float = 1.0) -> bool:
        path = self.scene.plan_motion(self._T_current, T_ee2world)
        if path is None:
            return False
        for wp in path:
            if not self._inner.move_to(wp, speed):
                return False
            self._T_current = np.asarray(wp, np.float64)
        return True

    def set_suction(self, on: bool) -> None:
        self._inner.set_suction(on)
        if on and self.scene.attached_instance is None:
            tool = self._T_current[:3, 3]
            best, best_d = None, self._grasp_reach
            for obj in self.scene.world_objects():
                d = float(
                    np.linalg.norm(obj.T_cad2world[:3, 3] - tool)
                )
                if d < best_d:
                    best, best_d = obj.instance_id, d
            if best is not None:
                self.scene.attach(best, self._T_current)
        elif not on:
            self.scene.detach(self._T_current)

    def check_grasped(self) -> bool:
        return self._inner.check_grasped()

    def home(self) -> bool:
        ok = self._inner.home()
        if ok:
            self._T_current = self._T_home.copy()
        return ok
