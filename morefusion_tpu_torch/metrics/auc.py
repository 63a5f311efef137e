"""Accuracy-over-threshold AUCs.

Port of ``morefusion_tpu/metrics/auc.py``. ``ycb_video_add_auc`` is the
YCB_Video_toolbox VOCap formula, the scoreboard of every pose number, kept
bit for bit. ``auc_for_errors`` integrates by the trapezoid rule in NumPy
where the JAX copy calls ``sklearn.metrics.auc``, which computes the same.
"""

from __future__ import annotations

import numpy as np

# NumPy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def auc_for_errors(errors, max_threshold, *, nstep=1000, return_xy=False):
    errors = np.asarray(errors)
    assert errors.ndim == 1
    assert errors.min() >= 0, f"min of errors must be >=0: {errors.min()}"

    x = np.linspace(0, max_threshold, nstep)
    y = (errors[None, :] <= x[:, None]).sum(axis=1) / errors.size

    auc = float(_trapezoid(y, x))
    auc = auc / (1.0 * max_threshold)  # scale to [0, 1]

    if return_xy:
        return auc, x, y
    return auc


def ycb_video_add_auc(adds, *, max_value=0.1, return_xy=False):
    """YCB-Video VOCap AUC over ADD errors (max threshold 0.1 m)."""
    adds = np.asarray(adds)
    assert adds.ndim == 1
    assert adds.min() >= 0, f"min of adds must be >=0: {adds.min()}"

    D = adds.copy()
    D[D > max_value] = np.inf
    d = np.sort(D)
    n = len(d)
    accuracy = np.cumsum(np.ones((1, n))) / n

    keep = np.isfinite(d)
    if keep.any():
        d = d[keep]
        accuracy = accuracy[keep]
        auc = _vocap(d, accuracy, max_value=max_value)
        x = np.r_[0, d, max_value]
        y = np.r_[0, accuracy, accuracy[-1]]
    else:
        auc = 0
        x = np.array([0, max_value], dtype=float)
        y = np.array([0, 0], dtype=float)

    if return_xy:
        return auc, x, y
    return auc


def _vocap(rec, prec, max_value=0.1):
    mrec = np.r_[0, rec, max_value]
    mpre = np.r_[0, prec, prec[-1]]
    mpre = np.maximum.accumulate(mpre)
    i = np.argwhere(mrec[1:] != mrec[:-1]) + 1
    return np.sum((mrec[i] - mrec[i - 1]) * mpre[i]) / max_value
