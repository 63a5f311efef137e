"""What the evaluation CLIs share: the model of a run directory, the val
set, its frames and the best-confidence pose of each crop.

A run directory is what ``cli/train.py`` writes (``args.json`` and the
snapshots), or just ``args.json`` beside a best archive
``snapshot_model_best_validation_main_auc.npz`` of either package.
"""

from __future__ import annotations

import numpy as np
import torch

N_FG_CLASS = 21
BEST_METRIC = "validation/main/auc"

# --grid-variant -> the Transform's eval case (the occupancy ablation axis):
# observed maps (MF), full nontarget CAD grids (MF+target-), full grids
# with the background (MF+target-+bg)
EVAL_CASES = {
    "observed": "empty+nontarget",
    "nontarget_full": "empty+nontarget_full",
    "full_bg": "empty+nontarget_full+other_full",
}


def with_occupancy_of(train_args) -> bool:
    return bool(train_args.get("with_occupancy", False)
                or "occupancy" in train_args.get("loss", ""))


def build_model(train_args, device, bf16: bool = False):
    """The run's SingleView3D (``tiny`` when it was trained tiny) on
    ``device``, its weights not loaded yet."""
    from .. import models

    kw = dict(n_point=train_args.get("n_point", 1000),
              with_occupancy=with_occupancy_of(train_args),
              compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    if train_args.get("tiny"):
        model = models.tiny_singleview3d(N_FG_CLASS, **kw)
    else:
        model = models.SingleView3D(n_fg_class=N_FG_CLASS, **kw)
    return model.to(device)


def restore(model, log_dir):
    """Load the run's best-AUC weights into ``model``, else its latest
    snapshot's; a run with neither keeps the fresh weights, as the JAX
    scripts do. Returns ``model``."""
    from ..training import CheckpointManager, create_train_state

    mgr = CheckpointManager(log_dir)
    if mgr.restore_best(model, BEST_METRIC) is None:
        mgr.restore_latest(create_train_state(model))
    return model


def open_val(path):
    """A packed or reindexed val set."""
    from .. import datasets

    if datasets.is_packed(path):
        return datasets.PackedPoseDataset(path, split="val")
    return datasets.RGBDPoseEstimationDatasetReIndexed(path, split="val")


def frames_of(ds, n):
    """``{frame: [crop index, ...]}`` of the first ``n`` crops, grouped by
    the packed index's ``frame/instance`` ids (every crop is its own frame
    where there are none), in order."""
    ex_ids = (ds.example_ids if hasattr(ds, "example_ids")
              else [str(i) for i in range(len(ds))])
    frames = {}
    for i in range(n):
        frames.setdefault(ex_ids[i].split("/")[0], []).append(i)
    return frames


def pad_batch(batch, batch_size):
    """``(batch padded to batch_size with copies of its first crop, the
    number of real crops)``, rgb as float32."""
    B = len(batch["class_id"])
    if B < batch_size:
        take = list(range(B)) + [0] * (batch_size - B)
        batch = {k: np.asarray(v)[take] for k, v in batch.items()}
    batch = dict(batch)
    batch["rgb"] = np.asarray(batch["rgb"]).astype(np.float32)
    return batch, B


def predict_best(model, batch):
    """``(quaternions (B, 4), translations (B, 3))`` host arrays: each
    crop's best-confidence pose, its points drawn as the eval step draws
    them."""
    from ..training.trainer import EVAL_SEED, _model_inputs

    device = next(model.parameters()).device
    keys = ["class_id", "rgb", "pcd", "pitch"]
    if model.with_occupancy:
        keys += ["origin", "grid_nontarget_empty"]
    b = {k: torch.as_tensor(np.asarray(batch[k]), device=device)
         for k in keys}
    if model.with_occupancy:
        b["grid_nontarget_empty"] = b["grid_nontarget_empty"].float()
    generator = torch.Generator(device=device).manual_seed(EVAL_SEED)
    with torch.no_grad():
        quat, trans, conf = model(**_model_inputs(model, b),
                                  generator=generator)
        best = conf.argmax(dim=1)
        ar = torch.arange(quat.shape[0], device=device)
        out = torch.cat([quat[ar, best], trans[ar, best]], 1).float()
    out = out.cpu().numpy()
    return out[:, :4], out[:, 4:]


def pose_matrices(q, t):
    """``(n, 4, 4)`` float64 poses of float32 quaternions and
    translations, formed in float32 as the JAX scripts form them."""
    from ..functions import transformation_matrix

    T = transformation_matrix(torch.as_tensor(np.asarray(q, np.float32)),
                              torch.as_tensor(np.asarray(t, np.float32)))
    return T.numpy().astype(np.float64)
