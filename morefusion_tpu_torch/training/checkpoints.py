"""Checkpoints and resume: torch state dicts plus JAX's npz archive.

Port of ``morefusion_tpu/training/checkpoints.py`` with ``torch.save`` /
``torch.load`` in place of orbax: a rolling ``snapshot_trainer_latest``
(the model, the optimizer, the learning-rate schedule's state and the
step) and model-only best-by-metric snapshots, each paired with its
archive ``<name>.npz``.

The archive is the JAX package's format (``export_params_npz``): one
compressed npz whose keys are flax key strings (``jax.tree_util.keystr``
of the variables tree) behind ``bf16:`` (float leaves, rounded to nearest
even and stored as a uint16 view) or ``raw:``. Both packages read each
other's archives.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models.convert_jax import load_jax_npz, params_from_jax, params_to_jax

LATEST = "snapshot_trainer_latest"


def _save(obj, path):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, out_dir: str):
        self._dir = os.path.abspath(out_dir)
        os.makedirs(self._dir, exist_ok=True)
        self._best = {}

    def _path(self, name: str) -> str:
        return os.path.join(self._dir, name)

    def save_latest(self, state, step: int) -> None:
        _save(dict(model=state.model.state_dict(),
                   optimizer=state.optimizer.state_dict(),
                   scheduler=state.scheduler.state_dict(),
                   step=int(step)), self._path(LATEST))

    def save_best(self, model, metric_name: str, value: float,
                  mode: str = "max") -> bool:
        """Save a model-only snapshot and its archive when the metric
        improves."""
        best = self._best.get(metric_name)
        improved = (
            best is None
            or (mode == "max" and value > best)
            or (mode == "min" and value < best)
        )
        if improved:
            self._best[metric_name] = value
            name = self._path(
                f"snapshot_model_best_{metric_name.replace('/', '_')}")
            _save(model.state_dict(), name)
            export_params_npz(model, name + ".npz")
        return improved

    def restore_latest(self, state):
        """``state`` with the latest snapshot loaded into it, or None."""
        path = self._path(LATEST)
        if not os.path.isfile(path):
            return None
        device = next(state.model.parameters()).device
        ckpt = torch.load(path, map_location=device, weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.scheduler.load_state_dict(ckpt["scheduler"])
        state.step = int(ckpt["step"])
        return state

    def restore_best(self, model, metric_name: str):
        """``model`` with a best snapshot loaded into it (from its archive
        where the snapshot is missing), or None."""
        path = self._path(
            f"snapshot_model_best_{metric_name.replace('/', '_')}")
        if os.path.isfile(path):
            device = next(model.parameters()).device
            model.load_state_dict(torch.load(path, map_location=device,
                                             weights_only=True))
            return model
        if os.path.exists(path + ".npz"):
            return import_params_npz(model, path + ".npz")
        return None


def params_npz_entries(model) -> dict:
    """The archive's entries of ``model``'s weights, as JAX's
    ``export_params_npz`` writes them: float leaves rounded to bf16
    (nearest even) and stored as uint16, in flax's leaf order."""
    out = {}
    for key, arr in params_to_jax(model.state_dict()).items():
        bf16 = torch.from_numpy(arr).to(torch.bfloat16)
        out["bf16:" + key] = bf16.view(torch.int16).numpy().view(np.uint16)
    return out


def export_params_npz(model, path: str) -> None:
    """Archive ``model``'s weights (``params_npz_entries``) as one
    compressed npz."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **params_npz_entries(model))
    os.replace(tmp, path)


def _load_leaves(template: dict, data: dict, path: str) -> dict:
    out = {}
    for key, tpl in template.items():
        if key not in data:
            raise KeyError(f"{path} is missing leaf {key}")
        arr = np.asarray(data[key], np.float32)
        if arr.shape != tpl.shape:
            raise ValueError(
                f"shape mismatch for {key}: {arr.shape} vs {tpl.shape}")
        out[key] = arr
    return out


def import_params_npz(model, path: str):
    """Load an archive of ``export_params_npz`` (either package's) into
    ``model``; every leaf of the model must be in it."""
    template = params_to_jax(model.state_dict())
    leaves = _load_leaves(template, load_jax_npz(path), path)
    model.load_state_dict(params_from_jax(leaves))
    return model


def import_backbone_npz(model, path: str):
    """Graft a backbone archive (keys ``['resnet_extractor'][...]``, JAX's
    ``pretrain_backbone.py`` export) into ``model.resnet_extractor``'s
    parameters, leaving every other weight as it is (BatchNorm statistics
    included, as JAX grafts only the ``params`` subtree)."""
    prefix = "['params']"
    template = {k[len(prefix):]: v
                for k, v in params_to_jax(model.state_dict()).items()
                if k.startswith(prefix + "['resnet_extractor']")}
    leaves = _load_leaves(template, load_jax_npz(path), path)
    state = params_from_jax({prefix + k: v for k, v in leaves.items()})
    missing = set(state) - set(model.state_dict())
    assert not missing, missing
    model.load_state_dict(state, strict=False)
    return model
