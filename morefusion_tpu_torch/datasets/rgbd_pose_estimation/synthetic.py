"""On-the-fly synthetic frame source for the pose-estimation factory.

Own copy of ``morefusion_tpu/datasets/rgbd_pose_estimation/synthetic.py``:
each index deterministically generates a cluttered scene (SDF placement +
point-splat render, the port's ``simulation/scene_generation.py``) and
yields the common ``get_frame`` dict. Combined with ``reindex`` this
materializes a flat npz training set with no external data.
"""

from __future__ import annotations

import numpy as np

from ...simulation.scene_generation import PlaneTypeSceneGeneration
from ..procedural import ProceduralModels
from .base import RGBDPoseEstimationDatasetBase


class SyntheticRGBDPoseEstimationDataset(RGBDPoseEstimationDatasetBase):
    """Deterministic synthetic scenes: one frame per index."""

    def __init__(
        self,
        split: str = "train",
        models=None,
        class_ids=None,
        n_frames: int = 200,
        n_objects=(3, 6),
        seed: int = 0,
        image_shape=(240, 320),
        n_points_per_object: int = 15000,
        settle: str = "physics",
        native_mapping: bool = True,
    ):
        super().__init__(models or ProceduralModels(), class_ids=class_ids,
                         native_mapping=native_mapping)
        self._split = split
        self._ids = list(range(n_frames))
        self._n_objects = n_objects
        self._seed = seed + (0 if split == "train" else 10_000_019)
        self._image_shape = image_shape
        self._n_points_per_object = n_points_per_object
        self._settle = settle

    def get_frame(self, index) -> dict:
        rng = np.random.RandomState(
            (self._seed * 1_000_003 + int(index)) % (2**32 - 1)
        )
        n_obj = rng.randint(self._n_objects[0], self._n_objects[1] + 1)
        gen = PlaneTypeSceneGeneration(
            self._models,
            n_object=n_obj,
            class_ids=self._class_ids and list(self._class_ids),
            random_state=rng,
            settle=self._settle,
        )
        gen.generate()
        eye = gen.random_camera_trajectory(n_keypoints=4, n_points=2)[0]
        return gen.render_frame(
            eye,
            shape=self._image_shape,
            n_points_per_object=self._n_points_per_object,
        )
