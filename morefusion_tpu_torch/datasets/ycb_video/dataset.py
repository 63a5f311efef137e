"""YCB-Video frame datasets (real data, when present on disk).

Own copy of ``morefusion_tpu/datasets/ycb_video/dataset.py`` (reference
``morefusion/datasets/ycb_video/dataset.py:13-104``): image-set split
files, and a per-frame loader of ``-meta.mat``, ``-color.png``,
``-depth.png`` (divided by ``factor_depth``, 0 -> NaN) and ``-label.png``.
Expects the standard ``YCB_Video_Dataset`` layout under
``$MOREFUSION_TPU_DATA/ycb_video/YCB_Video_Dataset``, or ``root_dir``.

The PNGs are read with imageio where it is installed, else with cv2 (the
rule of ``extra.viz.image_writer``): cv2 reads them unchanged (a uint16
depth stays uint16) and its BGR(A) becomes RGB(A), so both give the same
arrays.
"""

from __future__ import annotations

import os

import numpy as np

from ...extra.viz import image_writer
from ...utils.provenance import get_data_path
from ..base import DatasetBase
from ..rgbd_pose_estimation.base import RGBDPoseEstimationDatasetBase


def read_png(path: str) -> np.ndarray:
    """A PNG as imageio returns it: RGB(A) channel order, its own dtype."""
    if image_writer() == "imageio":
        import imageio.v2 as imageio

        return np.asarray(imageio.imread(path))
    import cv2

    image = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise OSError(f"cv2 could not read {path}")
    if image.ndim == 3:  # cv2 reads BGR(A)
        image = image[..., [2, 1, 0, 3][: image.shape[2]]]
    return image


class YCBVideoDataset(DatasetBase):

    _data_dir = "data"

    def __init__(self, split: str = "train", root_dir: str = None):
        if split not in ("train", "val", "trainval", "keyframe"):
            raise ValueError(f"unknown split: {split}")
        self._root_dir = root_dir or get_data_path(
            "ycb_video", "YCB_Video_Dataset"
        )
        if not os.path.isdir(self._root_dir):
            raise IOError(
                f"YCB_Video_Dataset not found at {self._root_dir}; set "
                "MOREFUSION_TPU_DATA or use the synthetic pipeline"
            )
        self._split = split
        imageset = os.path.join(
            self._root_dir, "image_sets", f"{split}.txt"
        )
        with open(imageset) as f:
            self._ids = [line.strip() for line in f if line.strip()]

    def get_frame(self, image_id: str) -> dict:
        import scipy.io

        base = os.path.join(self._root_dir, self._data_dir, image_id)
        meta = scipy.io.loadmat(
            base + "-meta.mat", squeeze_me=True, struct_as_record=True
        )
        color = read_png(base + "-color.png")
        depth = read_png(base + "-depth.png")
        depth = depth.astype(np.float32) / meta["factor_depth"]
        depth[depth == 0] = np.nan
        label = read_png(base + "-label.png").astype(np.int32)

        # a one-object frame squeezes to a scalar id and a (3, 4) pose
        class_ids = np.atleast_1d(meta["cls_indexes"]).astype(np.int32)
        poses = meta["poses"].reshape(3, 4, -1)
        Ts = np.tile(np.eye(4), (poses.shape[2], 1, 1))
        Ts[:, :3, :4] = poses.transpose(2, 0, 1)

        return dict(
            rgb=color[:, :, :3],
            depth=depth,
            # the label image holds class ids; instances == classes here
            instance_label=label - 1,  # 0 background -> -1
            instance_ids=class_ids - 1,
            class_ids=class_ids,
            intrinsic_matrix=np.asarray(
                meta["intrinsic_matrix"], dtype=np.float64
            ),
            T_cam2world=np.eye(4),
            Ts_cad2cam=Ts,
        )

    def get_example(self, index):
        return self.get_frame(self._ids[index])


class YCBVideoSyntheticDataset(YCBVideoDataset):
    """The ``data_syn`` split: rendered-only YCB-Video frames.

    Reference ``morefusion/datasets/ycb_video/synthetic_dataset.py:1-23``:
    ids come from ``data_syn/*-meta.mat`` (there is no image-set file for
    the synthetic frames). The reference recipe mixes them with the real
    frames (``train.py:263-310``).
    """

    _data_dir = "data_syn"

    def __init__(self, root_dir: str = None):
        self._root_dir = root_dir or get_data_path(
            "ycb_video", "YCB_Video_Dataset"
        )
        data_dir = os.path.join(self._root_dir, self._data_dir)
        if not os.path.isdir(data_dir):
            raise IOError(f"data_syn not found at {data_dir}")
        self._split = "syn"
        self._ids = sorted(
            f.split("-")[0]
            for f in os.listdir(data_dir)
            if f.endswith("-meta.mat")
        )


class YCBVideoRGBDPoseEstimationDataset(RGBDPoseEstimationDatasetBase):
    """Instance-example factory over YCB-Video frames.

    Reference ``rgbd_pose_estimation/ycb_video/dataset.py``: every
    ``sampling``-th frame of ``train``, the keyframes for ``val``, every
    frame of ``syn``.
    """

    def __init__(
        self, split: str = "train", models=None, class_ids=None,
        sampling: int = 8, root_dir: str = None,
    ):
        if models is None:
            from .models import YCBVideoModels

            models = YCBVideoModels()
        super().__init__(models, class_ids=class_ids)
        self._split = split
        if split == "syn":
            self._frames = YCBVideoSyntheticDataset(root_dir=root_dir)
            self._ids = list(range(len(self._frames)))
            return
        frame_split = "keyframe" if split == "val" else "train"
        self._frames = YCBVideoDataset(frame_split, root_dir=root_dir)
        ids = list(range(len(self._frames)))
        if split == "train":
            ids = ids[::sampling]
        self._ids = ids

    def get_frame(self, index):
        return self._frames.get_example(self._ids[index])
