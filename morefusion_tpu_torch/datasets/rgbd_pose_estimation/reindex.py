"""Offline materialization: factory examples -> flat random-access npz.

Own copy of ``morefusion_tpu/datasets/rgbd_pose_estimation/reindex.py``:
converts the expensive per-frame pipeline (occupancy fusion + visibility
render) into flat training files + a meta.json index. ``n_workers > 1``
forks worker processes; they run NumPy and the C++ mapping only, never
CUDA.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

import numpy as np


def _task(args):
    reindexed_root_dir, dataset, index = args
    image_id = dataset.ids[index]
    examples = dataset.get_example(index)
    id_to_meta = {}
    for i_example, example in enumerate(examples):
        instance_id = f"{image_id:08d}/{i_example:08d}"
        npz_file = os.path.join(reindexed_root_dir, f"{instance_id}.npz")
        os.makedirs(os.path.dirname(npz_file), exist_ok=True)
        np.savez_compressed(npz_file, **example)
        id_to_meta[instance_id] = {
            "class_id": int(example["class_id"]),
            "visibility": float(example["visibility"]),
        }
    return id_to_meta


def reindex(
    reindexed_root_dir: str,
    datasets: list,
    n_workers: Optional[int] = None,
    progress: bool = True,
):
    """Materialize every example of every dataset under root_dir."""
    os.makedirs(reindexed_root_dir, exist_ok=True)
    id_to_meta: dict = {}

    tasks = [
        (reindexed_root_dir, ds, i) for ds in datasets for i in range(len(ds))
    ]
    if n_workers is None:
        n_workers = os.cpu_count() or 1

    if n_workers <= 1:
        results = map(_task, tasks)
    else:
        ex = ProcessPoolExecutor(
            max_workers=n_workers,
            mp_context=multiprocessing.get_context("fork"))
        results = ex.map(_task, tasks)
    try:
        for k, meta in enumerate(results):
            id_to_meta.update(meta)
            if progress and (k + 1) % 20 == 0:
                print(f"reindex: {k + 1}/{len(tasks)}")
    finally:
        if n_workers > 1:
            ex.shutdown()

    with open(os.path.join(reindexed_root_dir, "meta.json"), "w") as f:
        json.dump(id_to_meta, f, indent=2)
    return id_to_meta


def rebuild_meta(
    reindexed_root_dir: str, drop_last_frame: bool = True
) -> dict:
    """Reconstruct meta.json for a partially materialized directory.

    ``reindex`` writes meta.json only on completion; a generation run cut
    short leaves a directory of valid per-instance npz files with no index.
    This rebuilds it from the files themselves. ``drop_last_frame``
    discards the highest frame id, which may have been mid-write at the
    cutoff.
    """
    frames = sorted(
        d
        for d in os.listdir(reindexed_root_dir)
        if os.path.isdir(os.path.join(reindexed_root_dir, d))
    )
    if drop_last_frame and frames:
        frames = frames[:-1]
    id_to_meta: dict = {}
    for frame in frames:
        fdir = os.path.join(reindexed_root_dir, frame)
        for name in sorted(os.listdir(fdir)):
            if not name.endswith(".npz"):
                continue
            instance_id = f"{frame}/{name[:-4]}"
            with np.load(os.path.join(fdir, name)) as z:
                id_to_meta[instance_id] = {
                    "class_id": int(z["class_id"]),
                    "visibility": float(z["visibility"]),
                }
    with open(os.path.join(reindexed_root_dir, "meta.json"), "w") as f:
        json.dump(id_to_meta, f, indent=2)
    return id_to_meta
