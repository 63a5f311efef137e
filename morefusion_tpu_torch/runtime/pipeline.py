"""End-to-end scene pipeline: the reference's ROS graph as a host service.

Port of ``morefusion_tpu/runtime/pipeline.py``. Fusion, tracking, grid
extraction and object mapping run on the host (NumPy and the C++ mapping
backend); the pose network and ICC run on ``device`` (the card unless the
caller passes ``device="cpu"``). Chains the runtime nodes exactly like
the reference launch graph (SURVEY.md §3.4: camera -> instance segmentation -> OctomapServer ->
pose CNN -> object mapping -> collision refinement -> picking order),
with ROS topics replaced by direct calls — the ROS bindings stay a thin
adapter on top of this class. Segmentation is pluggable: ground-truth
labels, or any callable returning (instance_label, {id: class_id}), such as
``models.SegmentationNode``. The pipeline serves whatever ``compute_dtype``
the pose model carries; its inputs, poses and ICC stay fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..contrib.collision_refine import IterativeCollisionCheck
from ..datasets.ycb_video.class_names import class_ids_symmetric
from ..geometry.pointcloud import pointcloud_from_depth
from ..geometry.transform import transform_points_np
from .fusion import OccupancyFusion
from .object_mapping import ObjectMapping
from .pose_estimation import PoseEstimationNode


class ScenePipeline:
    def __init__(
        self,
        model,
        models,
        segmenter: Optional[Callable] = None,
        voxel_dim: int = 32,
        with_icp: bool = False,
        n_votes: int = 3,
        native_mapping: bool = True,
        size_filter: bool = True,
        async_refine: bool = False,
        device="cuda",
    ):
        """``model`` is a port ``SingleView3D`` that holds its weights;
        ``models`` a model bank (``get_voxel_pitch``, ``get_pcd``,
        ``get_solid_voxel_grid``)."""
        self._device = torch.device(device)
        self._models = models
        self._segmenter = segmenter
        self._voxel_dim = voxel_dim
        self.fusion = OccupancyFusion(
            models, voxel_dim=voxel_dim, native=native_mapping,
            size_filter=size_filter,
        )
        self.pose_node = PoseEstimationNode(
            model, models.get_voxel_pitch, voxel_dim=voxel_dim,
            with_icp=with_icp, cad_points=models.get_pcd, device=device,
        )
        self._n_votes = n_votes
        # async_refine mirrors the reference's node graph (collision
        # refinement is its own ROS node consuming the pose stream): the
        # ICC program for frame k is dispatched without blocking and its
        # result is read back at frame k+1 (or flush()) — the device
        # refines while the host works on the next frame, cutting the
        # refine round trip out of the frame critical path.
        self._async_refine = async_refine
        self._pending_refine = None  # (icc, [instance ids])
        self.last_refined: Dict[int, np.ndarray] = {}
        self.object_mapping = ObjectMapping(
            models, class_ids_symmetric, n_votes=n_votes
        )
        self.last_poses: Dict[int, dict] = {}

    def reset(self):
        self.fusion.reset()
        self.object_mapping = ObjectMapping(
            self._models, class_ids_symmetric, n_votes=self._n_votes
        )
        self.last_poses = {}
        self._pending_refine = None
        self.last_refined = {}

    def warmup(self, n_objects=(1, 2, 4, 8)):
        """Run the joint refinement once for the common live-object-count
        buckets, so that no frame in the serving loop pays the kernel
        build or a first call."""
        IterativeCollisionCheck.warmup_buckets(
            n_objects, voxel_dim=self._voxel_dim, max_points=2048,
            device=self._device,
        )

    def flush_refine(self) -> Dict[int, np.ndarray]:
        """Resolve a pending async refinement; returns {id: T_cad2world}."""
        if self._pending_refine is not None:
            icc, ids = self._pending_refine
            self._pending_refine = None
            refined, _, _ = icc.resolve()
            self.last_refined = dict(zip(ids, refined))
        return self.last_refined

    def _prepare(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        K: np.ndarray,
        T_cam2world: np.ndarray,
        instance_label: Optional[np.ndarray] = None,
        instance_to_class: Optional[Dict[int, int]] = None,
    ) -> dict:
        """Host/native phase: segmentation, mapping fusion, grid
        extraction. Produces everything the device pose program needs."""
        if instance_label is None:
            if self._segmenter is None:
                raise ValueError(
                    "no segmenter configured and no labels provided"
                )
            instance_label, instance_to_class = self._segmenter(rgb, depth)

        pcd_cam = pointcloud_from_depth(
            depth, fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2]
        )
        # world-frame cloud for mapping
        H, W = depth.shape
        flat = pcd_cam.reshape(-1, 3)
        valid = ~np.isnan(flat).any(axis=1)
        pcd_world = np.full_like(flat, np.nan)
        pcd_world[valid] = transform_points_np(flat[valid], T_cam2world)
        pcd_world = pcd_world.reshape(H, W, 3)

        # 1-2) fuse + track
        label = self.fusion.process_frame(
            pcd_world,
            instance_label,
            instance_to_class or {},
            K=K,
            T_cam2world=T_cam2world,
            camera_origin=T_cam2world[:3, 3],
        )
        inst_to_class = self.fusion.instance_to_class

        # 3) all live instances' grids in ONE native extraction (origin
        # from each instance's observed cloud, class-specific pitch); the
        # pose CNN's no-entry grids and ICC's target/no-entry pair are
        # both sliced from this result, quantized to uint8 occupancy for
        # the device transfers
        noentry = {}
        grid_meta = {}
        grid_cache = {}
        finite = ~np.isnan(pcd_world).any(axis=2)
        live = []
        for ins_id, class_id in inst_to_class.items():
            mask = (label == ins_id) & finite
            if not mask.any():
                continue
            pts = pcd_world[mask]
            pitch = self._models.get_voxel_pitch(self._voxel_dim, class_id)
            center = np.median(pts, axis=0)
            origin = center - pitch * (self._voxel_dim / 2.0 - 0.5)
            live.append((ins_id, pitch, origin))
        if live:
            ids_l = [x[0] for x in live]
            pitch_l = [x[1] for x in live]
            origin_l = np.stack([x[2] for x in live])
            g_t, g_n, g_e = self.fusion.get_grids_batch(
                ids_l, pitch_l, origin_l
            )
            to_u8 = lambda g: (  # noqa: E731
                np.clip(g, 0.0, 1.0) * 255.0
            ).round().astype(np.uint8)
            g_t_u8 = to_u8(g_t)
            gne_u8 = to_u8(np.maximum(g_n, g_e))
            for k, ins_id in enumerate(ids_l):
                noentry[ins_id] = gne_u8[k]
                grid_meta[ins_id] = (pitch_l[k], origin_l[k])
                grid_cache[ins_id] = (g_t_u8[k], gne_u8[k])

        return dict(
            rgb=rgb,
            pcd_cam=pcd_cam,
            label=label,
            inst_to_class=inst_to_class,
            noentry=noentry,
            grid_meta=grid_meta,
            grid_cache=grid_cache,
            T_cam2world=T_cam2world,
        )

    def _dispatch_pose(self, ctx: dict):
        """Launch the device pose program for a prepared frame (async)."""
        return self.pose_node.dispatch(
            ctx["rgb"],
            ctx["pcd_cam"],
            ctx["label"],
            ctx["inst_to_class"],
            noentry_grids=ctx["noentry"],
        )

    def _finish(self, ctx: dict, handle, refine: bool) -> Dict[int, dict]:
        """Resolve the pose program, update temporal fusion, run/queue
        collision refinement."""
        grid_meta = ctx["grid_meta"]
        grid_cache = ctx["grid_cache"]
        T_cam2world = ctx["T_cam2world"]
        poses = self.pose_node.resolve(handle)

        # 5) temporal fusion in the world frame
        for ins_id, res in poses.items():
            T_cad2world = T_cam2world @ res["T_cad2cam"]
            res["T_cad2world"] = T_cad2world
            self.object_mapping.update(
                ins_id, res["class_id"], T_cad2world
            )

        # 6) joint collision refinement of spawned objects; in async mode
        # the previous frame's dispatch is resolved here (its result is
        # ~1 frame stale, like the reference's decoupled refinement node)
        # and this frame's refine is dispatched without blocking.
        if self._async_refine:
            for ins_id, T in self.flush_refine().items():
                if ins_id in poses:
                    poses[ins_id]["T_cad2world_refined"] = T
        spawned = self.object_mapping.spawned
        refine_ids = [i for i in spawned if i in grid_meta]
        if refine and len(refine_ids) >= 1:
            Ts, pts_l, sdf_l, pitch_l, origin_l, g_t, g_ne = (
                [], [], [], [], [], [], []
            )
            for ins_id in refine_ids:
                track = spawned[ins_id]
                vox = self._models.get_solid_voxel_grid(track.class_id)
                pts_l.append(vox.points.astype(np.float32))
                sdf_l.append(vox.inside_distance.astype(np.float32))
                pitch, origin = grid_meta[ins_id]
                pitch_l.append(pitch)
                origin_l.append(origin)
                Ts.append(track.pose)
                gt_u8, gne_u8 = grid_cache[ins_id]
                g_t.append(gt_u8)
                g_ne.append(gne_u8)
            icc = IterativeCollisionCheck(
                Ts, pts_l, sdf_l, pitch_l, origin_l,
                np.stack(g_t), np.stack(g_ne),
                voxel_dim=self._voxel_dim, max_points=2048,
                device=self._device,
            )
            if self._async_refine:
                icc.refine_async(iterations=30)
                self._pending_refine = (icc, list(refine_ids))
            else:
                refined, _, _ = icc.refine(iterations=30)
                for ins_id, T in zip(refine_ids, refined):
                    if ins_id in poses:
                        poses[ins_id]["T_cad2world_refined"] = T

        self.last_poses = poses
        return poses

    def process_frame(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        K: np.ndarray,
        T_cam2world: np.ndarray,
        instance_label: Optional[np.ndarray] = None,
        instance_to_class: Optional[Dict[int, int]] = None,
        refine: bool = True,
    ) -> Dict[int, dict]:
        """Run the full per-frame pipeline; returns per-instance results
        (poses in the camera frame, plus world-frame poses)."""
        ctx = self._prepare(
            rgb, depth, K, T_cam2world, instance_label, instance_to_class
        )
        handle = self._dispatch_pose(ctx)
        return self._finish(ctx, handle, refine)

    def process_stream(self, frames, refine: bool = True):
        """Software-pipelined serving loop: one frame in flight.

        ``frames`` yields dicts with keys rgb/depth/K/T_cam2world and
        optional instance_label/instance_to_class. For each frame the
        pose program is DISPATCHED (async), then the NEXT frame's
        host/native phase (segmentation + C++ fusion + grid extraction)
        runs while the device computes — the
        overlap the sequential ``process_frame`` loop cannot express.
        Results stream out in order, each one frame behind the prepare
        phase (the reference gets the same overlap from its decoupled
        ROS nodes, SURVEY.md §3.4).
        """
        prev = None
        for frame in frames:
            ctx = self._prepare(
                frame["rgb"],
                frame["depth"],
                frame["K"],
                frame["T_cam2world"],
                frame.get("instance_label"),
                frame.get("instance_to_class"),
            )
            handle = self._dispatch_pose(ctx)
            if prev is not None:
                yield self._finish(prev[0], prev[1], refine)
            prev = (ctx, handle)
        if prev is not None:
            yield self._finish(prev[0], prev[1], refine)
