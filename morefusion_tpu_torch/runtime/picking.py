"""Occlusion-graph picking-order selection.

Own copy of ``morefusion_tpu/runtime/picking.py`` (host, NumPy), on the
port's point-splat renderer ``extra/render.py``.

Port of the reference's ``select_picking_order`` node
(``ros/src/morefusion_ros/nodes/select_picking_order.py:27-347``): render
each mapped object alone and the whole scene; object j occludes object i
when j's visible pixels cover part of i's full-model silhouette. The
picking order removes occluders first (leaf-first traversal of the
occlusion DAG) until the target is reachable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..extra.render import render_scene


def build_occlusion_graph(
    models,
    class_ids: Sequence[int],
    Ts_cad2cam: Sequence[np.ndarray],
    K: np.ndarray,
    shape,
    min_occlusion_ratio: float = 0.02,
    n_points_per_object: int = 8000,
) -> Dict[int, set]:
    """occluded_by[i] = set of object indices occluding object i."""
    n = len(class_ids)
    scene = render_scene(
        models, class_ids, Ts_cad2cam, K, shape,
        n_points_per_object=n_points_per_object,
    )
    visible = [scene["instance_label"] == i for i in range(n)]

    occluded_by: Dict[int, set] = {i: set() for i in range(n)}
    for i in range(n):
        alone = render_scene(
            models, [class_ids[i]], [Ts_cad2cam[i]], K, shape,
            n_points_per_object=n_points_per_object,
        )
        full_i = alone["instance_label"] == 0
        denom = max(int(full_i.sum()), 1)
        hidden = full_i & ~visible[i]
        for j in range(n):
            if j == i:
                continue
            overlap = (hidden & visible[j]).sum() / denom
            if overlap > min_occlusion_ratio:
                occluded_by[i].add(j)
    return occluded_by


def select_picking_order(
    occluded_by: Dict[int, set], target: int
) -> List[int]:
    """Pick occluders before the objects they cover, ending at ``target``.

    Walk the occlusion DAG upward from the target; emit objects whose
    occluders have all been picked (cycle fallback: pick the least-occluded
    remaining object).
    """
    # restrict to the ancestors of target (objects blocking the way)
    needed = set()
    stack = [target]
    while stack:
        i = stack.pop()
        if i in needed:
            continue
        needed.add(i)
        stack.extend(occluded_by.get(i, ()))

    order: List[int] = []
    remaining = set(needed)
    while remaining:
        free = [
            i
            for i in remaining
            if not (occluded_by.get(i, set()) & remaining)
        ]
        if not free:  # occlusion cycle — break it greedily
            free = [
                min(
                    remaining,
                    key=lambda i: len(occluded_by.get(i, set()) & remaining),
                )
            ]
        # deterministic: lowest index first, but target always last
        free = sorted(free, key=lambda i: (i == target, i))
        nxt = free[0]
        order.append(nxt)
        remaining.discard(nxt)
    return order


def suction_grasp_pose(
    points: np.ndarray, normals: np.ndarray, up=(0, 0, -1)
) -> Optional[np.ndarray]:
    """Top-surface suction pose: the most camera/up-facing surface point.

    Reference: ``select_picking_order.py:299-333`` (surface-normal grasp).
    Returns a (4, 4) gripper pose with z-axis along the inward normal.
    """
    if len(points) == 0:
        return None
    up = np.asarray(up, float)
    up = up / np.linalg.norm(up)
    score = normals @ up
    k = int(np.argmax(score))
    n = normals[k] / np.linalg.norm(normals[k])

    z = -n  # approach along the inward normal
    x = np.cross([0.0, 1.0, 0.0], z)
    if np.linalg.norm(x) < 1e-6:
        x = np.cross([1.0, 0.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2] = x, y, z
    T[:3, 3] = points[k]
    return T
