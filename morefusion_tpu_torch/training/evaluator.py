"""Pose-estimation evaluation: per-class ADD records -> AUC / <2cm tables.

Port of ``morefusion_tpu/training/evaluator.py``: each eval batch gives
per-instance (class_id, add, add_s, add_or_add_s) records; they are
gathered to the host and summarized into per-class VOCap AUC (max 0.1 m)
and <2 cm accuracy, then averaged over the classes.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from ..metrics import ycb_video_add_auc


def summarize_records(
    class_ids: np.ndarray,
    adds: Dict[str, np.ndarray],
    max_value: float = 0.1,
    threshold_2cm: float = 0.02,
) -> Dict[str, float]:
    """Per-class AUC/<2cm tables + averages.

    Args:
      class_ids: (N,) per-instance class ids.
      adds: name -> (N,) error arrays ('add', 'add_s', 'add_or_add_s').

    Returns:
      {'main/add/auc': ..., 'main/add/auc/0002': ..., 'main/add/<2cm': ...}
    """
    out: Dict[str, float] = {}
    for name, errors in adds.items():
        errors = np.asarray(errors, dtype=float)
        per_class_auc: List[float] = []
        per_class_2cm: List[float] = []
        for cid in np.unique(class_ids):
            sel = class_ids == cid
            e = np.clip(errors[sel], 0.0, None)
            auc = ycb_video_add_auc(e, max_value=max_value)
            lt = float((e < threshold_2cm).mean())
            out[f"main/{name}/auc/{cid:04d}"] = float(auc)
            out[f"main/{name}/<2cm/{cid:04d}"] = lt
            per_class_auc.append(float(auc))
            per_class_2cm.append(lt)
        out[f"main/{name}/auc"] = (
            float(np.mean(per_class_auc)) if per_class_auc else 0.0)
        out[f"main/{name}/<2cm"] = (
            float(np.mean(per_class_2cm)) if per_class_2cm else 0.0)
        out[f"main/{name}"] = float(errors.mean()) if errors.size else 0.0
    return out


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class Evaluator:
    """Accumulate eval-step outputs (tensors or arrays) and summarize."""

    def __init__(self):
        self._class_ids: List[np.ndarray] = []
        self._records = defaultdict(list)

    def add_batch(self, step_output: Dict) -> None:
        out = {k: _host(v) for k, v in step_output.items()}
        self._class_ids.append(out.pop("class_id"))
        for k, v in out.items():
            self._records[k].append(v)

    def summarize(self) -> Dict[str, float]:
        if not self._class_ids:
            return {}
        class_ids = np.concatenate(self._class_ids)
        adds = {k: np.concatenate(v) for k, v in self._records.items()}
        return summarize_records(class_ids, adds)

    def records(self) -> Dict[str, list]:
        """Per-instance records (json-serializable), for resampling the
        val crops."""
        if not self._class_ids:
            return {}
        out = {"class_id": np.concatenate(self._class_ids).tolist()}
        for k, v in self._records.items():
            out[k] = np.concatenate(v).astype(float).tolist()
        return out

    def reset(self) -> None:
        self._class_ids.clear()
        self._records.clear()
