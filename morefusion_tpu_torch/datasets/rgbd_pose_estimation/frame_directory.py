"""Recorded-frame dataset: a directory of npz frames -> example factory.

Port of ``morefusion_tpu/datasets/rgbd_pose_estimation/frame_directory.py``.
Each ``<root>/<id>.npz`` holds the frame contract keys (``FRAME_KEYS``),
exactly what ``SceneGenerationBase.render_frame`` returns, in the JAX
package's layout: a directory written by either package is read by the
other.
"""

from __future__ import annotations

import os

import numpy as np

from .base import RGBDPoseEstimationDatasetBase

FRAME_KEYS = (
    "rgb",
    "depth",
    "instance_label",
    "instance_ids",
    "class_ids",
    "intrinsic_matrix",
    "T_cam2world",
    "Ts_cad2cam",
)


def save_frame(path: str, frame: dict) -> None:
    """Write the frame's ``FRAME_KEYS`` (those it has) to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, **{k: frame[k] for k in FRAME_KEYS if k in frame})


class FrameDirectoryDataset(RGBDPoseEstimationDatasetBase):
    """The frames of ``root_dir`` in the order of their ids, as a source of
    per-instance pose examples."""

    def __init__(self, root_dir: str, models, class_ids=None,
                 native_mapping: bool = True):
        super().__init__(models, class_ids=class_ids,
                         native_mapping=native_mapping)
        if not os.path.isdir(root_dir):
            raise IOError(f"{root_dir} does not exist")
        self._root_dir = root_dir
        self._ids = sorted(
            f[:-4] for f in os.listdir(root_dir) if f.endswith(".npz"))

    def get_frame(self, index) -> dict:
        return dict(np.load(
            os.path.join(self._root_dir, self._ids[index] + ".npz")))
