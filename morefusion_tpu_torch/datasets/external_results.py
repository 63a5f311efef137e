"""External pose-result loaders (comparison harnesses).

Port of ``morefusion_tpu/datasets/external_results.py``: a list of records
``{image_id, class_id, T_cad2cam (4, 4)}``, loaded from a plain JSON dump
or from the PoseCNN toolbox's ``.mat`` results (NumPy and SciPy on the
host).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..utils.provenance import get_data_path
from .base import DatasetBase


def load_results_json(path: str) -> List[dict]:
    """``[{image_id, class_id, T_cad2cam (16 floats or nested)}]`` from a
    JSON file; ``image_id`` may be absent (None)."""
    with open(path) as f:
        rows = json.load(f)
    return [dict(image_id=r.get("image_id"), class_id=int(r["class_id"]),
                 T_cad2cam=np.asarray(r["T_cad2cam"],
                                      dtype=np.float64).reshape(4, 4))
            for r in rows]


def load_posecnn_mat(path: str) -> List[dict]:
    """One PoseCNN toolbox results ``.mat`` -> records.

    Layout (YCB_Video_toolbox): ``rois (N, 7)`` with the class id in column
    1, ``poses (N, 7)`` a quaternion (w, x, y, z) and a translation. Rows of
    class id 0 or less are skipped; ``image_id`` is the file's stem."""
    import scipy.io

    from ..geometry.transform import quaternion_matrix_np

    data = scipy.io.loadmat(path, squeeze_me=True)
    rois = np.atleast_2d(data["rois"])
    poses = np.atleast_2d(data["poses"])
    image_id = os.path.splitext(os.path.basename(path))[0]
    out = []
    for roi, pose in zip(rois, poses):
        class_id = int(roi[1])
        if class_id <= 0:
            continue
        T = quaternion_matrix_np(pose[:4])
        T[:3, 3] = pose[4:7]
        out.append(dict(image_id=image_id, class_id=class_id, T_cad2cam=T))
    return out


class YCBVideoPoseCNNResultsDataset(DatasetBase):
    """PoseCNN's keyframe results: one example (a list of records) per
    ``.mat`` of the toolbox's ``results_PoseCNN_RSS2018`` directory (by
    default under the data root, ``utils.get_data_path``)."""

    def __init__(self, root_dir: Optional[str] = None):
        self._root_dir = root_dir or get_data_path(
            "ycb_video", "YCB_Video_toolbox", "results_PoseCNN_RSS2018")
        if not os.path.isdir(self._root_dir):
            raise IOError(f"PoseCNN results not found at {self._root_dir}")
        self._ids = sorted(f[:-4] for f in os.listdir(self._root_dir)
                           if f.endswith(".mat"))
        self._split = "keyframe"

    def get_example(self, index) -> List[dict]:
        return load_posecnn_mat(
            os.path.join(self._root_dir, self._ids[index] + ".mat"))
