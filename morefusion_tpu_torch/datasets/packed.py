"""Packed memory-mapped training store: the fast host input path.

Own copy of ``morefusion_tpu/datasets/packed.py``. A reindexed directory is materialized once into flat preallocated
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

The transfer form adds ``z16.npy`` (N, 256, 256) float16 and
``pcd_coef.npy`` (N, 4) float32 (``derive_transfer_arrays``): with
``transfer=True`` a batch carries the depth and the affine coefficients of
its cloud in place of the float32 cloud, and ships to the device as one
packed buffer (``training/transfer.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from ..parallel import distributed
from .base import DatasetBase
from .rgbd_pose_estimation.augmentation import augment_mask, augment_mask_z

_GRID_KEYS = (
    "grid_target",
    "grid_nontarget",
    "grid_empty",
    "grid_target_full",
)
_SCALAR_KEYS = (
    "class_id", "quaternion_true", "translation_true", "origin", "pitch",
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


def has_transfer_arrays(root_dir: str) -> bool:
    return (os.path.exists(os.path.join(root_dir, "z16.npy"))
            and os.path.exists(os.path.join(root_dir, "pcd_coef.npy")))


def derive_transfer_arrays(root_dir: str, chunk: int = 256, progress=True):
    """Write the transfer form of the packed cloud: ``z16.npy`` (N, H, W)
    float16 and ``pcd_coef.npy`` (N, 4) float32 (``transfer.fit_pcd_coefs``)
    beside the packed arrays, in one pass over ``pcd.npy``; returns the
    coefficients.

    Atomic: both arrays are written under ``.tmp`` names and renamed into
    place when complete, the coefficients first, so an interrupted derive
    never leaves a ``z16.npy`` that ``has_transfer_arrays`` accepts. Under
    a process group of several ranks only rank 0 derives; the others wait
    for the rename.
    """
    from ..training.transfer import fit_pcd_coefs

    if distributed.world_size() > 1 and not distributed.is_primary():
        while not has_transfer_arrays(root_dir):
            time.sleep(1.0)
        return np.load(os.path.join(root_dir, "pcd_coef.npy"))

    pcd = np.load(os.path.join(root_dir, "pcd.npy"), mmap_mode="r")
    n, H, W = pcd.shape[:3]
    z16_tmp = os.path.join(root_dir, "z16.npy.tmp")
    coef_tmp = os.path.join(root_dir, "pcd_coef.npy.tmp")
    z16 = np.lib.format.open_memmap(z16_tmp, mode="w+", dtype=np.float16,
                                    shape=(n, H, W))
    coef = np.zeros((n, 4), np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = np.asarray(pcd[lo:hi])
        z16[lo:hi] = block[..., 2]
        coef[lo:hi] = fit_pcd_coefs(block)
        if progress and (lo // chunk) % 8 == 0:
            print(f"derive_transfer: {hi}/{n}")
    z16.flush()
    del z16
    with open(coef_tmp, "wb") as f:
        np.save(f, coef)
    # the coefficients first: has_transfer_arrays wants both files, and
    # z16.npy is the one a concurrent open would memmap
    os.rename(coef_tmp, os.path.join(root_dir, "pcd_coef.npy"))
    os.rename(z16_tmp, os.path.join(root_dir, "z16.npy"))
    return coef


class PackedPoseDataset(DatasetBase):
    """Memmap-backed pose-estimation training set.

    ``get_example`` matches the npz ReIndexed loader contract (so the
    transforms and evaluators work unchanged); ``load_batch`` is the
    vectorized fast path used by the batch loader. With ``transfer`` a
    batch holds ``z`` (float16) and ``pcd_coef`` in place of ``pcd``
    (``get_example`` still rebuilds the cloud).
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
        if not is_packed(root_dir):
            raise IOError(f"{root_dir} is not a packed dataset")
        if transfer and not has_transfer_arrays(root_dir):
            raise IOError(f"{root_dir} has no transfer arrays "
                          "(run derive_transfer_arrays first)")
        self._root_dir = root_dir
        self._split = split
        self._augmentation = augmentation
        self._rng = np.random.RandomState(seed)
        self._transfer = transfer

        sc = np.load(os.path.join(root_dir, "scalars.npz"))
        self._scalars = {k: sc[k] for k in sc.files}
        self._mm = {
            k: np.load(os.path.join(root_dir, f"{k}.npy"), mmap_mode="r")
            for k in ("rgb", "pcd") + _GRID_KEYS + ("grid_nontarget_full",)
        }
        if transfer:
            del self._mm["pcd"]  # z16 + the coefficients replace the cloud
            self._mm["z"] = np.load(os.path.join(root_dir, "z16.npy"),
                                    mmap_mode="r")
            self._coef = np.load(os.path.join(root_dir, "pcd_coef.npy"))

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
        with the mask truncation of ``augment_mask`` (``augment_mask_z``
        in the transfer form) per example when ``augmentation`` (the
        photometric part runs in the train step)."""
        idx = self._indices[np.asarray(indices, dtype=np.int64)]
        batch = {k: np.asarray(m[idx]) for k, m in self._mm.items()}
        for k in _SCALAR_KEYS:
            batch[k] = self._scalars[k][idx]
        if self._transfer:
            batch["pcd_coef"] = self._coef[idx].copy()
        if self._augmentation:
            rgbs = batch["rgb"]
            if self._transfer:
                zs, coefs = batch["z"], batch["pcd_coef"]
                for b in range(len(idx)):
                    rgbs[b], zs[b], coefs[b] = augment_mask_z(
                        rgbs[b], zs[b], coefs[b], self._rng)
            else:
                pcds = batch["pcd"]
                for b in range(len(idx)):
                    rgbs[b], pcds[b] = augment_mask(rgbs[b], pcds[b],
                                                    self._rng)
        return batch

    def get_example(self, index):
        batch = self.load_batch([index])
        ex = {k: v[0] for k, v in batch.items()}
        if self._transfer:
            # the npz loader's contract wants the organized cloud
            z = ex.pop("z").astype(np.float32)
            a, b, c, d = ex.pop("pcd_coef")
            H, W = z.shape
            x = z * (a + b * np.arange(W, dtype=np.float32))
            y = z * (c + d * np.arange(H, dtype=np.float32)[:, None])
            ex["pcd"] = np.stack([x, y, z], axis=-1)
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
