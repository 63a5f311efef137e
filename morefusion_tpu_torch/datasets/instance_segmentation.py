"""Instance-segmentation training data.

Own copy of ``morefusion_tpu/datasets/instance_segmentation.py``: frames of
the synthetic generator become segmentation examples. The UNet reads dense
class maps, so the main format is ``(rgb, class_label (H, W) int32)``;
``format='masks'`` gives the detector tuple ``(rgb, bboxes, labels,
masks)`` and ``format='instance'`` adds depth, the boundary target and the
instance label. Host only (NumPy, cv2).
"""

from __future__ import annotations

import os

import numpy as np

from ..geometry.bbox import masks_to_bboxes
from .base import DatasetBase
from .procedural import ProceduralModels
from .rgbd_pose_estimation.synthetic import SyntheticRGBDPoseEstimationDataset


def frame_to_class_label(frame: dict) -> np.ndarray:
    """instance_label + class ids -> dense class map (0 = background)."""
    label = frame["instance_label"]
    out = np.zeros(label.shape, np.int32)
    for ins_id, cls_id in zip(frame["instance_ids"], frame["class_ids"]):
        out[label == ins_id] = cls_id
    return out


def frame_to_masks(frame: dict):
    """Reference tuple format: (rgb, bboxes, labels, masks)."""
    label = frame["instance_label"]
    masks, labels = [], []
    for ins_id, cls_id in zip(frame["instance_ids"], frame["class_ids"]):
        m = label == ins_id
        if not m.any():
            continue
        masks.append(m)
        labels.append(cls_id)
    masks = (
        np.stack(masks) if masks else np.zeros((0,) + label.shape, bool)
    )
    labels = np.asarray(labels, np.int32)
    bboxes = masks_to_bboxes(masks) if len(masks) else np.zeros((0, 4))
    return frame["rgb"], bboxes, labels, masks


class SyntheticInstanceSegmentationDataset(DatasetBase):
    """Synthetic frames -> segmentation training examples."""

    def __init__(
        self,
        split: str = "train",
        n_frames: int = 200,
        image_shape=(240, 320),
        format: str = "class_label",
        seed: int = 0,
        n_objects=(3, 6),
        background_composite: bool = True,
        background_dir=None,
        cache: bool = True,
    ):
        assert format in ("class_label", "masks", "instance")
        self._format = format
        self._composite = None
        if background_composite:
            from .background_composite import BackgroundComposite

            self._composite = BackgroundComposite(
                image_dir=background_dir, seed=seed
            )
        self._frames = SyntheticRGBDPoseEstimationDataset(
            split=split,
            n_frames=n_frames,
            image_shape=image_shape,
            seed=seed,
            n_objects=n_objects,
        )
        self._split = split
        self._ids = list(range(n_frames))
        # frames are deterministic per index and slow to make on the host,
        # so later epochs reuse them; the background composite stays per
        # call (a fresh texture draw)
        self._cache = {} if cache else None
        # optional cross-process disk cache (MFTPU_SEG_CACHE=dir): frames
        # are deterministic per (split, seed, shape, n_objects, index),
        # so other processes can make them ahead of the training
        self._disk_dir = None
        root = os.environ.get("MFTPU_SEG_CACHE")
        if root:
            key = (
                f"{split}_s{seed}_{image_shape[0]}x{image_shape[1]}"
                f"_o{n_objects[0]}-{n_objects[1]}"
            )
            self._disk_dir = os.path.join(root, key)
            os.makedirs(self._disk_dir, exist_ok=True)

    def _disk_frame(self, index):
        """Load (or generate + atomically store) one raw frame on disk."""
        path = os.path.join(self._disk_dir, f"{index:06d}.npz")
        if os.path.exists(path):
            with np.load(path) as f:
                return {k: f[k] for k in f.files}
        frame = self._frames.get_frame(index)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:  # file handle: savez must not append
            np.savez(f, **frame)    # ".npz" to the tmp name (rename
        os.replace(tmp, path)       # below would then miss it)
        return frame

    def get_example(self, index):
        if self._cache is not None and index in self._cache:
            frame = self._cache[index]
        else:
            if self._disk_dir is not None:
                frame = self._disk_frame(index)
            else:
                frame = self._frames.get_frame(index)
            if self._cache is not None:
                self._cache[index] = frame
        if self._composite is not None:
            frame = dict(
                frame,
                rgb=self._composite(
                    frame["rgb"], frame["instance_label"]
                ),
            )
        if self._format == "masks":
            return frame_to_masks(frame)
        if self._format == "instance":
            from ..models.segmentation import boundary_from_instance_label

            return dict(
                rgb=frame["rgb"].astype(np.float32),
                depth=np.nan_to_num(frame["depth"]).astype(np.float32),
                class_label=frame_to_class_label(frame),
                boundary=boundary_from_instance_label(
                    frame["instance_label"]
                ),
                instance_label=frame["instance_label"].astype(np.int32),
            )
        return dict(
            rgb=frame["rgb"].astype(np.float32),
            class_label=frame_to_class_label(frame),
        )
