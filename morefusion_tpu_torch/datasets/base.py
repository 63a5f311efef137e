"""Dataset and model-bank contracts of the port.

Own copy of ``morefusion_tpu/datasets/base.py``: datasets expose
``root_dir / split / ids`` and ``get_example``; ``ConcatDataset`` joins
several; a model bank exposes per-class CAD assets (surface point cloud,
SDF, solid voxel grid, voxel pitch).
"""

from __future__ import annotations

import numpy as np


class DatasetBase:
    _root_dir = None
    _split = None
    _ids = None

    @property
    def root_dir(self):
        return self._root_dir

    @property
    def split(self):
        return self._split

    @property
    def ids(self):
        return self._ids

    def __len__(self):
        return len(self.ids)

    def get_example(self, index):
        raise NotImplementedError

    def __getitem__(self, index):
        return self.get_example(index)


class ConcatDataset(DatasetBase):
    """Concatenation of datasets (the real + synthetic mixing recipe).

    Keeps the packed fast path: when every child supports ``load_batch``,
    a batch's indices are grouped per child, loaded vectorized, and
    re-merged in request order.
    """

    def __init__(self, *datasets):
        assert datasets
        self._datasets = list(datasets)
        self._sizes = np.array([len(d) for d in self._datasets])
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)])
        self._ids = list(range(int(self._sizes.sum())))
        self._split = getattr(datasets[0], "split", None)

    def _locate(self, index):
        child = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return child, int(index - self._offsets[child])

    def get_example(self, index):
        child, local = self._locate(int(index))
        return self._datasets[child].get_example(local)

    @property
    def supports_load_batch(self) -> bool:
        return all(getattr(d, "supports_load_batch", False)
                   for d in self._datasets)

    def load_batch(self, indices) -> dict:
        if not self.supports_load_batch:
            raise AttributeError("not all children support load_batch")
        indices = np.asarray(indices, dtype=np.int64)
        child = np.searchsorted(self._offsets, indices, side="right") - 1
        local = indices - self._offsets[child]
        order = np.empty(len(indices), np.int64)
        pos = 0
        chunks = []
        for c in np.unique(child):
            sel = np.nonzero(child == c)[0]
            chunks.append(self._datasets[c].load_batch(local[sel]))
            order[sel] = np.arange(pos, pos + len(sel))
            pos += len(sel)
        return {k: np.concatenate([ch[k] for ch in chunks])[order]
                for k in chunks[0]}


class VoxelGrid:
    """Solid voxelization result: occupied voxel centers + metadata.

    Stands in for the reference's binvox-backed
    ``trimesh.voxel.VoxelGrid`` (only ``.points`` and pitch/origin are used
    downstream).
    """

    def __init__(self, points, pitch, origin, inside_distance=None):
        self.points = np.asarray(points)
        self.pitch = float(pitch)
        self.origin = np.asarray(origin)
        #: inside-positive distance per point (the reference's SDF
        #: convention from trimesh.proximity.signed_distance)
        self.inside_distance = (
            None if inside_distance is None else np.asarray(inside_distance)
        )


class ModelsBase:
    """Per-class CAD asset bank."""

    @property
    def class_names(self):
        raise NotImplementedError

    @property
    def n_class(self):
        return len(self.class_names)

    def get_pcd(self, class_id) -> np.ndarray:
        """(N, 3) surface points of the CAD model."""
        raise NotImplementedError

    def get_sdf(self, class_id):
        """(points (N, 3), inside-positive distance (N,)) for solid points."""
        raise NotImplementedError

    def get_solid_voxel_grid(self, class_id) -> VoxelGrid:
        raise NotImplementedError

    def get_bbox_diagonal(self, class_id) -> float:
        raise NotImplementedError

    def get_voxel_pitch(self, dimension, class_id) -> float:
        """Reference: ``bbox_diagonal / dimension``
        (``morefusion/datasets/ycb_video/models.py:113-115``)."""
        return self.get_bbox_diagonal(class_id) / dimension
