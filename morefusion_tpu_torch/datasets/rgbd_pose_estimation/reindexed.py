"""Flat npz training-set loader (+ optional augmentation).

Own copy of ``morefusion_tpu/datasets/rgbd_pose_estimation/reindexed.py``:
filters by class id and minimum visibility via meta.json; augmentations
are the cv2 ones of ``augmentation.py``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from ..base import DatasetBase
from .augmentation import augment_rgbd


class RGBDPoseEstimationDatasetReIndexed(DatasetBase):
    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        class_ids: Optional[Sequence[int]] = None,
        augmentation: bool = False,
        min_visibility: float = 0.0,
        seed: int = 0,
    ):
        if not os.path.isdir(root_dir):
            raise IOError(f"{root_dir} does not exist")
        self._root_dir = root_dir
        self._split = split
        self._class_ids = tuple(class_ids) if class_ids else None
        self._augmentation = augmentation
        self._min_visibility = min_visibility
        self._rng = np.random.RandomState(seed)

        with open(os.path.join(root_dir, "meta.json")) as f:
            self._meta = json.load(f)
        self._ids = self._get_ids()

    def _get_ids(self):
        ids = []
        for id_, meta in sorted(self._meta.items()):
            if self._class_ids and meta["class_id"] not in self._class_ids:
                continue
            if meta["visibility"] < self._min_visibility:
                continue
            ids.append(id_)
        return ids

    def get_example(self, index):
        id_ = self._ids[index]
        npz_file = os.path.join(self._root_dir, f"{id_}.npz")
        example = dict(np.load(npz_file))
        example.pop("visibility", None)

        if self._augmentation:
            rgb, pcd = augment_rgbd(
                example["rgb"], example["pcd"], self._rng
            )
            example["rgb"] = rgb
            example["pcd"] = pcd.astype(np.float32)
        return example


class RandomSamplingDataset(DatasetBase):
    """Fixed-seed random subsampling wrapper (balances the sizes of
    several training sources)."""

    def __init__(self, dataset, n_sample: int, seed: int = 0):
        self._dataset = dataset
        rng = np.random.RandomState(seed)
        n_sample = min(n_sample, len(dataset))
        self._indices = rng.permutation(len(dataset))[:n_sample]
        self._ids = list(range(n_sample))
        self._split = getattr(dataset, "split", None)

    def get_example(self, index):
        return self._dataset.get_example(int(self._indices[index]))

    @property
    def supports_load_batch(self) -> bool:
        return getattr(self._dataset, "supports_load_batch", False)

    def load_batch(self, indices) -> dict:
        """Packed fast-path passthrough (indices mapped into the child)."""
        if not self.supports_load_batch:
            raise AttributeError("wrapped dataset has no load_batch")
        return self._dataset.load_batch(
            self._indices[np.asarray(indices, dtype=np.int64)]
        )
