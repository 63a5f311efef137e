"""Packed memory-mapped training store: the fast host input path.

Own copy of ``morefusion_tpu/datasets/packed.py`` without its transfer
form. A reindexed directory is materialized once into flat preallocated
``.npy`` arrays; training then reads batches by fancy indexing into
page-cached memmaps: no decode, no per-example Python, one copy per array
per batch.

Layout of a packed dir::

    rgb.npy                 (N, 256, 256, 3) uint8
    pcd.npy                 (N, 256, 256, 3) float32   (NaN holes)
    grid_target.npy         (N, 32, 32, 32) bool       (prob > 0.5)
    grid_nontarget.npy      (N, 32, 32, 32) bool
    grid_empty.npy          (N, 32, 32, 32) bool
    grid_target_full.npy    (N, 32, 32, 32) bool
    grid_nontarget_full.npy (N, 32, 32, 32) uint8      (instance ids, 0=bg)
    scalars.npz             class_id/quaternion_true/translation_true/
                            origin/pitch/visibility

Probability grids are thresholded at pack time: the training transform's
first move is exactly that threshold, and the model never sees the raw
probabilities.

The JAX package's transfer form (``z16.npy`` + ``pcd_coef.npy``, one
compressed buffer a batch for a slow host link, ``training/transfer.py``)
is not ported: ``transfer=True`` and ``derive_transfer_arrays`` raise.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from .base import DatasetBase
from .rgbd_pose_estimation.augmentation import augment_mask

_GRID_KEYS = (
    "grid_target",
    "grid_nontarget",
    "grid_empty",
    "grid_target_full",
)
_SCALAR_KEYS = (
    "class_id", "quaternion_true", "translation_true", "origin", "pitch",
)
TRANSFER_NOT_PORTED = (
    "the packed transfer form (training/transfer.py) is not ported; "
    "ROADMAP.md queue 1, item 4"
)


def pack_reindexed(reindexed_dir: str, out_dir: str, progress: bool = True):
    """Convert a reindexed npz directory into a packed memmap store."""
    with open(os.path.join(reindexed_dir, "meta.json")) as f:
        meta = json.load(f)
    ids = sorted(meta.keys())
    n = len(ids)
    if n == 0:
        raise ValueError(f"no examples in {reindexed_dir}")

    os.makedirs(out_dir, exist_ok=True)
    first = dict(np.load(os.path.join(reindexed_dir, f"{ids[0]}.npz")))
    H, W = first["rgb"].shape[:2]
    V = first["grid_target"].shape[0]

    def open_mm(name, dtype, shape):
        return np.lib.format.open_memmap(
            os.path.join(out_dir, f"{name}.npy"), mode="w+", dtype=dtype,
            shape=shape)

    mm = {"rgb": open_mm("rgb", np.uint8, (n, H, W, 3)),
          "pcd": open_mm("pcd", np.float32, (n, H, W, 3))}
    for k in _GRID_KEYS:
        mm[k] = open_mm(k, bool, (n, V, V, V))
    mm["grid_nontarget_full"] = open_mm("grid_nontarget_full", np.uint8,
                                        (n, V, V, V))

    class_id = np.zeros(n, np.int32)
    quaternion_true = np.zeros((n, 4), np.float32)
    translation_true = np.zeros((n, 3), np.float32)
    origin = np.zeros((n, 3), np.float32)
    pitch = np.zeros(n, np.float32)
    visibility = np.zeros(n, np.float32)

    for i, id_ in enumerate(ids):
        ex = dict(np.load(os.path.join(reindexed_dir, f"{id_}.npz")))
        mm["rgb"][i] = ex["rgb"]
        mm["pcd"][i] = ex["pcd"]
        for k in ("grid_target", "grid_nontarget", "grid_empty"):
            mm[k][i] = ex[k] > 0.5
        mm["grid_target_full"][i] = ex["grid_target_full"] > 0
        mm["grid_nontarget_full"][i] = np.clip(
            ex["grid_nontarget_full"], 0, 255
        ).astype(np.uint8)
        class_id[i] = ex["class_id"]
        quaternion_true[i] = ex["quaternion_true"]
        translation_true[i] = ex["translation_true"]
        origin[i] = ex["origin"]
        pitch[i] = ex["pitch"]
        visibility[i] = float(ex.get("visibility", meta[id_]["visibility"]))
        if progress and (i + 1) % 500 == 0:
            print(f"pack: {i + 1}/{n}")

    for m in mm.values():
        m.flush()
    np.savez(
        os.path.join(out_dir, "scalars.npz"),
        class_id=class_id,
        quaternion_true=quaternion_true,
        translation_true=translation_true,
        origin=origin,
        pitch=pitch,
        visibility=visibility,
    )
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({"ids": ids}, f)
    return ids


def is_packed(root_dir: str) -> bool:
    return os.path.exists(os.path.join(root_dir, "scalars.npz"))


def derive_transfer_arrays(root_dir: str, chunk: int = 256, progress=True):
    raise NotImplementedError(TRANSFER_NOT_PORTED)


class PackedPoseDataset(DatasetBase):
    """Memmap-backed pose-estimation training set.

    ``get_example`` matches the npz ReIndexed loader contract (so the
    transforms and evaluators work unchanged); ``load_batch`` is the
    vectorized fast path used by the batch loader.
    """

    supports_load_batch = True

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        class_ids: Optional[Sequence[int]] = None,
        augmentation: bool = False,
        min_visibility: float = 0.0,
        seed: int = 0,
        transfer: bool = False,
    ):
        if transfer:
            raise NotImplementedError(TRANSFER_NOT_PORTED)
        if not is_packed(root_dir):
            raise IOError(f"{root_dir} is not a packed dataset")
        self._root_dir = root_dir
        self._split = split
        self._augmentation = augmentation
        self._rng = np.random.RandomState(seed)

        sc = np.load(os.path.join(root_dir, "scalars.npz"))
        self._scalars = {k: sc[k] for k in sc.files}
        self._mm = {
            k: np.load(os.path.join(root_dir, f"{k}.npy"), mmap_mode="r")
            for k in ("rgb", "pcd") + _GRID_KEYS + ("grid_nontarget_full",)
        }

        keep = self._scalars["visibility"] >= min_visibility
        if class_ids:
            keep &= np.isin(self._scalars["class_id"], list(class_ids))
        self._indices = np.nonzero(keep)[0]
        self._ids = list(range(len(self._indices)))

    @property
    def example_ids(self):
        """Original ``frame/instance`` string ids (filter-aligned)."""
        with open(os.path.join(self._root_dir, "index.json")) as f:
            all_ids = json.load(f)["ids"]
        return [all_ids[i] for i in self._indices]

    def load_batch(self, indices) -> dict:
        """Raw stacked batch (bool grids; rgb uint8) by fancy indexing,
        with the mask truncation of ``augment_mask`` per example when
        ``augmentation`` (the photometric part runs in the train step)."""
        idx = self._indices[np.asarray(indices, dtype=np.int64)]
        batch = {k: np.asarray(m[idx]) for k, m in self._mm.items()}
        for k in _SCALAR_KEYS:
            batch[k] = self._scalars[k][idx]
        if self._augmentation:
            rgbs, pcds = batch["rgb"], batch["pcd"]
            for b in range(len(idx)):
                rgbs[b], pcds[b] = augment_mask(rgbs[b], pcds[b], self._rng)
        return batch

    def get_example(self, index):
        batch = self.load_batch([index])
        ex = {k: v[0] for k, v in batch.items()}
        ex["class_id"] = int(ex["class_id"])
        ex["pitch"] = np.float32(ex["pitch"])
        # npz-loader contract: float probability grids, int full grids
        for k in ("grid_target", "grid_nontarget", "grid_empty"):
            ex[k] = ex[k].astype(np.float32)
        ex["grid_target_full"] = ex["grid_target_full"].astype(np.int32)
        ex["grid_nontarget_full"] = ex["grid_nontarget_full"].astype(
            np.int32
        )
        return ex
