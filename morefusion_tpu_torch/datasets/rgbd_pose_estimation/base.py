"""Frame -> per-instance training-example factory.

Own copy of ``morefusion_tpu/datasets/rgbd_pose_estimation/base.py``: each
frame (rgb, depth, instance_label, intrinsics, poses) yields one example
per foreground instance with:

- 256x256 centerized rgb/pcd crops (mask-applied),
- visibility = visible-mask pixels / full-model rendered pixels,
- voxel origin from the masked-pcd median, class-specific pitch,
- observed occupancy grids (target / nontarget / empty) from the
  multi-instance occupancy mapping,
- ground-truth full grids (target / nontarget) from posed solid CAD voxels.

The occupancy mapping is the C++ backend (``contrib/mapping_native.py``,
built with g++ at first use; a failed build raises) unless
``native_mapping=False`` selects the NumPy mapping, its oracle.
"""

from __future__ import annotations

import numpy as np

from ... import geometry as geometry_module
from ...contrib.occupancy_mapping import MultiInstanceOccupancyMapping
from ...extra.image import centerize
from ...extra.render import render_scene
from ..base import DatasetBase


class RGBDPoseEstimationDatasetBase(DatasetBase):

    _n_points_minimal = 1
    _image_size = 256
    _voxel_dim = 32

    def __init__(self, models, class_ids=None, native_mapping: bool = True):
        self._models = models
        if class_ids is not None:
            class_ids = tuple(class_ids)
        self._class_ids = class_ids
        self._native_mapping = native_mapping

    @property
    def models(self):
        """The CAD/asset bank this dataset draws from."""
        return self._models

    def get_frame(self, index) -> dict:
        raise NotImplementedError

    def build_mapping(self, pcd, instance_label, instance_ids, class_ids):
        """Fuse one frame into per-instance occupancy maps."""
        if self._native_mapping:
            from ...contrib import mapping_native

            mapping = mapping_native.NativeMultiInstanceMapping()
        else:
            mapping = MultiInstanceOccupancyMapping()
        nonnan = ~np.isnan(pcd).any(axis=2)

        for instance_id, class_id in zip(instance_ids, class_ids):
            if class_id <= 0:
                continue
            mask = (instance_label == instance_id) & nonnan
            pitch = self._models.get_voxel_pitch(self._voxel_dim, class_id)
            mapping.initialize(int(instance_id), pitch=pitch)
            mapping.integrate(int(instance_id), mask, pcd)

        # background = everything not belonging to a known instance
        mapping.initialize(-1, pitch=0.01)
        bg_mask = nonnan & ~np.isin(instance_label, instance_ids)
        mapping.integrate(-1, bg_mask, pcd)
        return mapping

    def _get_grid_full(self, examples, pitch, origin):
        dims = (self._voxel_dim,) * 3
        grid_full = np.zeros(dims, dtype=np.int32)
        for i, example in enumerate(examples):
            T = geometry_module.quaternion_matrix_np(
                example["quaternion_true"]
            )
            T[:3, 3] = example["translation_true"]
            vox = self._models.get_solid_voxel_grid(example["class_id"])
            points = vox.points @ T[:3, :3].T + T[:3, 3]
            indices = np.floor((points - origin) / pitch).astype(int)
            keep = ((indices >= 0) & (indices < self._voxel_dim)).all(axis=1)
            I, J, K = indices[keep].T
            grid_full[I, J, K] = i + 1  # ids start at 1
        return grid_full

    def get_example(self, index):
        frame = self.get_frame(index)

        instance_ids = frame["instance_ids"]
        class_ids = frame["class_ids"]
        rgb = frame["rgb"]
        depth = frame["depth"]
        instance_label = frame["instance_label"]
        K = frame["intrinsic_matrix"]
        Ts_cad2cam = frame["Ts_cad2cam"]
        H, W = depth.shape

        pcd = geometry_module.pointcloud_from_depth(
            depth, fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2]
        )

        if instance_ids.size == 0:
            return []

        mapping = self.build_mapping(
            pcd, instance_label, instance_ids, class_ids
        )

        examples = []
        for instance_id, class_id, T_cad2cam in zip(
            instance_ids, class_ids, Ts_cad2cam
        ):
            if class_id == 0:
                continue
            if self._class_ids and class_id not in self._class_ids:
                continue

            mask = instance_label == instance_id
            if not mask.any():
                continue
            bbox = geometry_module.masks_to_bboxes(mask)
            y1, x1, y2, x2 = bbox.round().astype(int)
            if (y2 - y1) * (x2 - x1) == 0:
                continue

            pcd_ins = pcd.copy()
            pcd_ins[~mask] = np.nan
            pcd_ins = pcd_ins[y1:y2, x1:x2]
            nonnan = ~np.isnan(pcd_ins).any(axis=2)
            if nonnan.sum() < self._n_points_minimal:
                continue
            pcd_ins = centerize(
                pcd_ins,
                (self._image_size, self._image_size),
                cval=np.nan,
                interpolation="nearest",
            )

            rgb_ins = rgb.copy()
            rgb_ins[~mask] = 0
            rgb_ins = rgb_ins[y1:y2, x1:x2]
            rgb_ins = centerize(rgb_ins, (self._image_size, self._image_size))

            # visibility: rendered full-model mask vs. visible mask
            rend = render_scene(
                self._models,
                [class_id],
                [T_cad2cam],
                K,
                (H, W),
                n_points_per_object=8000,
            )
            mask_rend = rend["instance_label"] >= 0
            visibility = float(1.0 * mask.sum() / max(mask_rend.sum(), 1))

            quaternion_true = geometry_module.quaternion_from_matrix(
                T_cad2cam)
            translation_true = geometry_module.translation_from_matrix(
                T_cad2cam)

            center = np.nanmedian(pcd_ins, axis=(0, 1))
            dim = self._voxel_dim
            pitch = self._models.get_voxel_pitch(dim, class_id)
            origin = center - (dim / 2.0 - 0.5) * pitch
            grid_target, grid_nontarget, grid_empty = (
                mapping.get_target_grids(
                    int(instance_id),
                    dimensions=(dim, dim, dim),
                    pitch=pitch,
                    origin=origin,
                )
            )

            examples.append(
                dict(
                    class_id=int(class_id),
                    rgb=rgb_ins,
                    pcd=pcd_ins.astype(np.float32),
                    quaternion_true=quaternion_true.astype(np.float32),
                    translation_true=translation_true.astype(np.float32),
                    visibility=visibility,
                    origin=origin.astype(np.float32),
                    pitch=np.float32(pitch),
                    grid_target=grid_target,
                    grid_nontarget=grid_nontarget,
                    grid_empty=grid_empty,
                )
            )

        # ground-truth full grids (needs all examples of the frame)
        n_examples = len(examples)
        for i_target, example in enumerate(examples):
            others = [
                examples[i] for i in range(n_examples) if i != i_target
            ]
            pitch = example["pitch"]
            origin = example["origin"]
            example["grid_target_full"] = self._get_grid_full(
                [example], pitch, origin
            )
            example["grid_nontarget_full"] = self._get_grid_full(
                others, pitch, origin
            )

        return examples
