"""Volumetric-fusion node: the OctomapServer loop as a host service.

Own copy of ``morefusion_tpu/runtime/fusion.py``. Per frame (reference
``OctomapServer::insertCloudCallback``, ``OctomapServer.cpp:91-455``):
  1. raycast-render the existing per-instance maps into a predicted
     instance-label image,
  2. match detected masks to map instances (IoU tracking),
  3. integrate the masked clouds into per-instance maps (+ background,
     with free-space carving along rays),
  4. on demand, extract per-instance 32^3 occupancy grids and the
     complementary no-entry grids the pose network consumes
     (``publishGrids``, ``OctomapServer.cpp:457-620``).

``native=True`` uses the C++ backend (``contrib/mapping_native.py``) and
raises where it cannot be built; ``native=False`` selects the NumPy
mapping. Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..contrib.mapping_native import NativeMultiInstanceMapping
from ..contrib.occupancy_mapping import MultiInstanceOccupancyMapping
from .tracking import track_instance_id

BG_INSTANCE = -1  # background map id (reference uses octree id -1)


def _make_mapping(native: bool):
    if native:
        return NativeMultiInstanceMapping()
    return MultiInstanceOccupancyMapping()


class OccupancyFusion:
    def __init__(
        self,
        models,
        voxel_dim: int = 32,
        native: bool = True,
        size_filter: bool = True,
    ):
        self._models = models
        self._voxel_dim = voxel_dim
        self._native = native
        self._size_filter = size_filter
        self.reset()

    def reset(self):
        self._mapping = _make_mapping(self._native)
        self._mapping.initialize(BG_INSTANCE, pitch=0.01)
        self._instance_to_class: Dict[int, int] = {}
        self._counter = 0

    @property
    def instance_to_class(self) -> Dict[int, int]:
        return dict(self._instance_to_class)

    def render_labels(
        self, K, T_cam2world, shape
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Predicted instance-label image from the current maps."""
        if hasattr(self._mapping, "render"):
            return self._mapping.render(K, T_cam2world, shape)
        return (
            np.full(shape, -2, np.int32),
            np.full(shape, np.nan, np.float32),
        )

    def process_frame(
        self,
        pcd_world: np.ndarray,  # (H, W, 3) world-frame cloud (NaN holes)
        detection_label: np.ndarray,  # (H, W) detector instance ids (<0 none)
        detection_classes: Dict[int, int],  # detection id -> class id
        K: Optional[np.ndarray] = None,
        T_cam2world: Optional[np.ndarray] = None,
        camera_origin=(0.0, 0.0, 0.0),
        track: bool = True,
    ) -> np.ndarray:
        """Fuse one frame; returns the tracked instance-label image."""
        H, W = detection_label.shape
        nonnan = ~np.isnan(pcd_world).any(axis=2)

        if track and K is not None and T_cam2world is not None:
            rendered, _ = self.render_labels(K, T_cam2world, (H, W))
            label, classes, self._counter = track_instance_id(
                rendered,
                detection_label,
                detection_classes,
                self._counter,
                size_filter=self._size_filter,
            )
        else:
            label = detection_label.copy()
            classes = dict(detection_classes)
            self._counter = max(
                [self._counter] + [i + 1 for i in classes]
            )

        for ins_id, class_id in classes.items():
            if ins_id not in self._instance_to_class:
                pitch = self._models.get_voxel_pitch(
                    self._voxel_dim, class_id
                )
                self._mapping.initialize(ins_id, pitch=pitch)
                self._instance_to_class[ins_id] = class_id
            mask = (label == ins_id) & nonnan
            if mask.any():
                self._mapping.integrate(
                    ins_id, mask, pcd_world, origin=camera_origin
                )

        bg_mask = (label < 0) & nonnan
        if bg_mask.any():
            self._mapping.integrate(
                BG_INSTANCE, bg_mask, pcd_world, origin=camera_origin
            )
        return label

    def get_grids_batch(self, instance_ids, pitches, origins):
        """(N, V, V, V) target/nontarget/empty grids for several instances
        in one native call (one extraction per frame instead of ~2 per
        instance: the pose CNN's no-entry grids and ICC's target/no-entry
        pair both derive from this one result)."""
        dims = (self._voxel_dim,) * 3
        if hasattr(self._mapping, "get_target_grids_batch"):
            return self._mapping.get_target_grids_batch(
                instance_ids, dimensions=dims, pitches=pitches,
                origins=origins,
            )
        outs = [
            self._mapping.get_target_grids(
                ins_id, dimensions=dims, pitch=pitch, origin=origin
            )
            for ins_id, pitch, origin in zip(
                instance_ids, pitches, origins
            )
        ]
        return tuple(np.stack(g) for g in zip(*outs))
