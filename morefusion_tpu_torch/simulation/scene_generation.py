"""Synthetic cluttered-scene generation (quasi-static SDF physics).

Own copy of ``morefusion_tpu/simulation/scene_generation.py`` (NumPy): the
same ``RandomState`` gives the same scenes and frames, bit for bit. It
replaces the reference's pybullet scene synthesis
(``morefusion/simulation/scene_generation/base.py:10-390``,
``bin_type.py``, ``plane_type.py``). Placement is rejection sampling with
SDF-based collision checks; settling is an impulse-free quasi-static
rigid-body relaxation (the reference settles with pybullet dynamics,
``base.py:66-77``): each object is dropped along -z by SDF sphere tracing
until contact, then tipped about the support-polygon edge nearest the
gravity line until its center of mass projects inside the support polygon
— the static-stability criterion a dynamics engine converges to, computed
directly. Objects stack: the clearance field includes the already-placed
objects, so drops land on the pile and tipping pivots on neighbors.

``settle="drop"`` keeps the legacy round-3 behavior (plane drop, spawn
orientation kept) for bit-exact reproduction of earlier datasets; the rng
draw sequence is identical in both modes.

Rendering goes through the point-splat renderer (``extra/render.py``)
instead of pybullet's OpenGL.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import geometry
from ..extra.render import render_scene
from ..geometry.transform import quaternion_matrix_np


def _random_rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return quaternion_matrix_np(q)


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation matrix about a unit axis (Rodrigues)."""
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )


def _convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Convex hull (CCW, no repeated endpoint) via monotone chain."""
    pts = np.unique(np.round(points, 6), axis=0)
    if len(pts) <= 2:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2:
                u, v = out[-1] - out[-2], p - out[-2]
                if u[0] * v[1] - u[1] * v[0] > 0:
                    break
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def _point_vs_hull(p: np.ndarray, hull: np.ndarray):
    """(inside, nearest boundary point, distance to boundary) in 2D.

    Degenerate hulls (point / segment contact, e.g. a cylinder on its
    side) report inside=False with the distance to that point/segment;
    callers treat "within tolerance of a line contact" as balanced.
    """
    if len(hull) == 1:
        d = float(np.linalg.norm(p - hull[0]))
        return False, hull[0], d
    # nearest point over boundary segments
    a = hull
    b = np.roll(hull, -1, axis=0) if len(hull) > 2 else hull[1:]
    ab = b - a
    t = np.clip(
        np.einsum("ij,ij->i", p - a[: len(ab)], ab)
        / np.maximum((ab ** 2).sum(axis=1), 1e-12),
        0.0,
        1.0,
    )
    proj = a[: len(ab)] + t[:, None] * ab
    d = np.linalg.norm(proj - p, axis=1)
    k = int(np.argmin(d))
    if len(hull) == 2:
        return False, proj[k], float(d[k])
    pa = p - a  # CCW hull: inside iff all 2D crosses >= 0
    cross = ab[:, 0] * pa[:, 1] - ab[:, 1] * pa[:, 0]
    inside = bool((cross >= -1e-12).all())
    return inside, proj[k], float(d[k])


class SceneGenerationBase:
    """Spawn objects into a workspace; render labeled RGB-D frames."""

    def __init__(
        self,
        models,
        n_object: int,
        *,
        extents=(0.4, 0.4, 0.3),
        class_ids: Optional[List[int]] = None,
        random_state: Optional[np.random.RandomState] = None,
        collision_margin: float = 0.002,
        settle: str = "physics",
    ):
        if settle not in ("physics", "drop"):
            raise ValueError(f"settle must be 'physics' or 'drop': {settle}")
        self._models = models
        self._n_object = n_object
        self._extents = np.asarray(extents, dtype=float)
        self._class_ids = class_ids or list(range(1, 22))
        self._rng = random_state or np.random.RandomState(0)
        self._margin = collision_margin
        self._settle = settle

        #: instance_id -> dict(class_id, T_cad2world)
        self.objects: Dict[int, dict] = {}

    # -- placement ------------------------------------------------------

    def _support_height(self, points_world: np.ndarray) -> float:
        """z offset needed so the object rests on plane / placed objects."""
        # plane support: lowest point at z = 0
        dz_plane = -points_world[:, 2].min()
        dz = dz_plane
        return dz

    def _is_colliding(self, points_world: np.ndarray) -> bool:
        for obj in self.objects.values():
            shape = self._models.get_shape(obj["class_id"])
            T = obj["T_cad2world"]
            R, t = T[:3, :3], T[:3, 3]
            local = (points_world - t) @ R
            if (shape.sdf(local) < self._margin).any():
                return True
        return False

    def _is_contained(self, points_world: np.ndarray) -> bool:
        half = self._extents / 2.0
        lo = np.array([-half[0], -half[1], 0.0])
        hi = np.array([half[0], half[1], self._extents[2]])
        contained = ((points_world >= lo) & (points_world <= hi)).all(axis=1)
        return contained.mean() > 0.95

    def _clearance(
        self, points_world: np.ndarray, bsphere=None
    ) -> np.ndarray:
        """Per-point distance to the nearest obstacle (plane + placed).

        Positive = free space, negative = penetration. 1-Lipschitz by
        construction (min of 1-Lipschitz fields), so it sphere-traces.
        ``bsphere=(center, radius)`` of the query set prunes placed
        objects whose own bounding sphere cannot intersect it.
        """
        c = points_world[:, 2].copy()
        for obj in self.objects.values():
            if bsphere is not None and "bsphere" in obj:
                oc, orad = obj["bsphere"]
                if np.linalg.norm(bsphere[0] - oc) > bsphere[1] + orad + 0.02:
                    continue
            shape = self._models.get_shape(obj["class_id"])
            T = obj["T_cad2world"]
            R, t = T[:3, :3], T[:3, 3]
            local = (points_world - t) @ R
            np.minimum(c, shape.sdf(local), out=c)
        return c

    def _settle_physics(
        self,
        shape,
        surface: np.ndarray,
        T: np.ndarray,
        *,
        rest_eps: float = 0.003,
        tip_step: float = 0.06,
        max_tips: int = 60,
    ) -> Optional[np.ndarray]:
        """Quasi-static settle: drop to contact, tip until statically stable.

        Replaces pybullet's ``stepSimulation`` loop (reference
        ``simulation/scene_generation/base.py:66-77``) with the fixed point
        that loop converges to: resting contact with the center of mass
        over the support polygon. Contact is checked symmetrically — the
        candidate's surface samples against the placed SDFs AND the placed
        objects' surface samples against the candidate's SDF — so thin
        features can't slip between sparse samples. Returns the settled
        pose, or None when the relaxation wedges or leaves the workspace.
        """
        T = T.copy()
        com_local = surface.mean(axis=0)
        radius = float(np.linalg.norm(surface - com_local, axis=1).max())
        # Tip-loop queries run on a half-resolution subsample (contact
        # sets stay ~mm-dense at 250 samples); the final drop + wedge /
        # containment validation below re-runs at full resolution.
        coarse = surface[::2]
        contact_tol = rest_eps + 0.002
        balance_tol = 0.002
        stale = 0
        best_d = np.inf
        placed = [
            obj["surface_world"]
            for obj in self.objects.values()
            if "surface_world" in obj
        ]
        placed_all = np.concatenate(placed) if placed else None

        def center_of(T):
            return T[:3, :3] @ com_local + T[:3, 3]

        def reverse_sdf(T):
            """Candidate's SDF sampled at the nearby placed surfaces."""
            if placed_all is None:
                return None
            near = placed_all[
                np.linalg.norm(placed_all - center_of(T), axis=1)
                < radius + 0.02
            ]
            if len(near) == 0:
                return None
            return near, shape.sdf((near - T[:3, 3]) @ T[:3, :3])

        def contact_state(T, pts_local):
            """One full clearance evaluation: (pts, c_vec, rev, cmin)."""
            pts = pts_local @ T[:3, :3].T + T[:3, 3]
            c = self._clearance(pts, bsphere=(center_of(T), radius))
            rev = reverse_sdf(T)
            cmin = float(c.min())
            if rev is not None:
                cmin = min(cmin, float(rev[1].min()))
            return pts, c, rev, cmin

        def drop_to_contact(T, pts_local):
            # Sphere-trace along -z (or push up out of penetration);
            # valid because both clearance fields are 1-Lipschitz in the
            # candidate's translation. Returns the last evaluation's
            # full state so the caller never re-evaluates it.
            state = contact_state(T, pts_local)
            for _ in range(60):
                cmin = state[3]
                if abs(cmin - rest_eps) < 2e-4:
                    break
                if cmin > rest_eps:
                    T[2, 3] -= cmin - rest_eps
                else:
                    T[2, 3] += rest_eps - cmin
                state = contact_state(T, pts_local)
            return T, state

        for _ in range(max_tips):
            T, (pts, c, rev, _) = drop_to_contact(T, coarse)
            contacts = pts[c < contact_tol]
            if rev is not None:
                near, rsdf = rev
                contacts = np.concatenate(
                    [contacts, near[rsdf < contact_tol]]
                )
            if len(contacts) == 0:
                contacts = pts[c < c.min() + 1e-3]
            hull = _convex_hull_2d(contacts[:, :2])
            com_w = T[:3, :3] @ com_local + T[:3, 3]
            inside, q, d = _point_vs_hull(com_w[:2], hull)
            if inside or d < balance_tol:
                break
            # d legitimately grows while tipping over an edge; only a long
            # run with no new minimum means edge-to-edge oscillation.
            if d < best_d - 1e-4:
                best_d, stale = d, 0
            else:
                stale += 1
                if stale > 20:
                    break
            # tip about the horizontal axis through the pivot edge
            u = com_w[:2] - q
            u /= max(np.linalg.norm(u), 1e-12)
            axis = np.array([-u[1], u[0], 0.0])
            near = contacts[
                np.argmin(np.linalg.norm(contacts[:, :2] - q, axis=1))
            ]
            pivot = np.array([q[0], q[1], near[2]])
            if np.cross(axis, com_w - pivot)[2] > 0:
                axis = -axis  # choose the sign that lowers the COM
            R = _axis_angle(axis, tip_step)
            T[:3, :3] = R @ T[:3, :3]
            T[:3, 3] = pivot + R @ (T[:3, 3] - pivot)
        # full-resolution final drop + validation (the coarse tip loop
        # may leave sub-mm penetration at skipped samples)
        T, (pts, _, _, cmin) = drop_to_contact(T, surface)
        if cmin < self._margin * 0.5:
            return None  # wedged: drop couldn't resolve a lateral contact
        if not self._is_contained(pts):
            return None
        return T

    _surface_cache: Dict[int, np.ndarray] = {}

    def _class_surface(self, class_id: int, shape) -> np.ndarray:
        key = (type(self._models).__name__, class_id)
        if key not in SceneGenerationBase._surface_cache:
            SceneGenerationBase._surface_cache[key] = shape.sample_surface(
                500, np.random.RandomState(class_id)
            )
        return SceneGenerationBase._surface_cache[key]

    def generate(self, max_trials_per_object: int = 30) -> None:
        instance_id = 0
        pile_top = 0.0
        for _ in range(self._n_object):
            class_id = int(self._rng.choice(self._class_ids))
            shape = self._models.get_shape(class_id)
            surface = self._class_surface(class_id, shape)
            for _trial in range(max_trials_per_object):
                T = _random_rotation(self._rng)
                half = self._extents / 2.0 * 0.7
                T[:2, 3] = self._rng.uniform(-half[:2], half[:2])
                T[2, 3] = self._rng.uniform(0.0, self._extents[2] * 0.5)

                pts = surface @ T[:3, :3].T + T[:3, 3]
                if self._settle == "physics":
                    # spawn fully above the pile, then relax to rest
                    T[2, 3] += pile_top + self._support_height(pts)
                    T_settled = self._settle_physics(shape, surface, T)
                    if T_settled is None:
                        continue
                    T = T_settled
                    pts = surface @ T[:3, :3].T + T[:3, 3]
                else:
                    # legacy: drop straight onto the plane, keep orientation
                    T[2, 3] += self._support_height(pts)
                    pts = surface @ T[:3, :3].T + T[:3, 3]
                    if self._is_colliding(pts):
                        continue
                    if not self._is_contained(pts):
                        continue
                center = pts.mean(axis=0)
                self.objects[instance_id] = dict(
                    class_id=class_id,
                    T_cad2world=T,
                    surface_world=pts,
                    bsphere=(
                        center,
                        float(np.linalg.norm(pts - center, axis=1).max()),
                    ),
                )
                pile_top = max(pile_top, float(pts[:, 2].max()))
                instance_id += 1
                break

    # -- cameras ---------------------------------------------------------

    def random_camera_trajectory(
        self,
        n_keypoints: int = 8,
        n_points: int = 15,
        distance=(0.6, 0.9),
        elevation=(30.0, 80.0),
    ) -> np.ndarray:
        """(n_points, 4, 4) smooth camera path looking at the workspace.

        Reference: sphere-sampled keypoints, greedy KD sort, spline
        interpolation (``scene_generation/base.py:352+``).
        """
        rng = self._rng
        eyes = geometry.points_from_angles(
            rng.uniform(*distance, n_keypoints),
            rng.uniform(*elevation, n_keypoints),
            rng.uniform(-180, 180, n_keypoints),
        )
        eyes = geometry.trajectory.sort(eyes)
        eyes = geometry.trajectory.interpolate(eyes, n_points)
        target = np.array([0.0, 0.0, 0.1])
        return np.stack([geometry.look_at(e, target) for e in eyes])

    # -- rendering --------------------------------------------------------

    def render_frame(
        self,
        T_cam2world: np.ndarray,
        K: Optional[np.ndarray] = None,
        shape=(480, 640),
        n_points_per_object: int = 30000,
    ) -> dict:
        """Render a labeled frame from a camera pose.

        Returns the dataset-factory frame contract
        (``rgbd_pose_estimation/base.py:get_frame``): rgb, depth,
        instance_label (-1 background), instance_ids, class_ids,
        intrinsic_matrix, T_cam2world, Ts_cad2cam.
        """
        H, W = shape
        if K is None:
            f = 0.6 * W
            K = np.array(
                [[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]]
            )
        T_world2cam = np.linalg.inv(T_cam2world)

        instance_ids = sorted(self.objects.keys())
        class_ids = [self.objects[i]["class_id"] for i in instance_ids]
        Ts_cad2cam = [
            T_world2cam @ self.objects[i]["T_cad2world"]
            for i in instance_ids
        ]
        out = render_scene(
            self._models,
            class_ids,
            Ts_cad2cam,
            K,
            (H, W),
            instance_ids=instance_ids,
            n_points_per_object=n_points_per_object,
        )
        return dict(
            rgb=out["rgb"],
            depth=out["depth"],
            instance_label=out["instance_label"],
            instance_ids=np.asarray(instance_ids, dtype=np.int32),
            class_ids=np.asarray(class_ids, dtype=np.int32),
            intrinsic_matrix=K,
            T_cam2world=T_cam2world,
            Ts_cad2cam=np.stack(Ts_cad2cam) if Ts_cad2cam else np.zeros((0, 4, 4)),
        )


class PlaneTypeSceneGeneration(SceneGenerationBase):
    """Objects resting on an open plane."""


class BinTypeSceneGeneration(SceneGenerationBase):
    """Objects inside a bin: tighter containment, walls block the view."""

    def _is_contained(self, points_world: np.ndarray) -> bool:
        half = self._extents / 2.0
        lo = np.array([-half[0], -half[1], 0.0])
        hi = np.array([half[0], half[1], self._extents[2]])
        return bool(((points_world >= lo) & (points_world <= hi)).all())
