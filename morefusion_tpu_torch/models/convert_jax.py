"""Carry flax parameters of ``morefusion_tpu`` models over to the port.

The JAX package archives checkpoints as one npz whose keys are
``"bf16:" + keystr`` (float leaves, stored through a uint16 view) or
``"raw:" + keystr``, with keystr like ``['params']['conv3']['kernel']``.
bf16 is the upper half of fp32, so a leaf decodes exactly as
``(u16.astype(uint32) << 16).view(float32)``, with no bf16 type needed.

Layouts: conv kernels ``(k..., I, O) -> (O, I, k...)``, Dense kernels
``(I, O) -> (O, I)``, PReLU's scalar slope -> ``(1,)``. The port's modules
are named after the flax tree, so ``['params']['a']['b']['kernel']`` becomes
``a.b.weight``. Norm layers: ``scale`` (BatchNorm, GroupNorm) becomes
``weight``; a BatchNorm's ``['batch_stats'][...]['mean' | 'var']`` become
``running_mean`` / ``running_var``. ``params_to_jax`` is the inverse:
a state dict back to flax's keys and layouts.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]")


def decode_bf16(u16: np.ndarray) -> np.ndarray:
    return (np.asarray(u16, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def load_jax_npz(path) -> Dict[str, np.ndarray]:
    """Checkpoint npz -> ``{keystr: float32 or raw array}``."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            kind, _, name = key.partition(":")
            if kind == "bf16":
                out[name] = decode_bf16(data[key])
            elif kind == "raw":
                out[name] = data[key]
            else:
                raise ValueError(f"{path}: unknown leaf kind in {key!r}")
    return out


def _to_torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if arr.ndim == 2:
            return arr.T
        # (k..., I, O) -> (O, I, k...)
        return arr.transpose(arr.ndim - 1, arr.ndim - 2,
                             *range(arr.ndim - 2))
    if leaf == "negative_slope":
        return arr.reshape(1)
    return arr


_RENAME = {
    "params": {"kernel": "weight", "negative_slope": "weight",
               "scale": "weight"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def params_from_jax(np_params: Dict[str, np.ndarray]):
    """``{keystr: array}`` of a flax ``{'params': ...}`` tree, and of its
    ``'batch_stats'`` if it has any -> state dict."""
    state = {}
    for key, arr in np_params.items():
        path = _KEY.findall(key)
        if not path or path[0] not in _RENAME:
            raise ValueError(f"not a params or batch_stats leaf: {key!r}")
        *mods, leaf = path[1:]
        name = _RENAME[path[0]].get(leaf)
        if name is None and path[0] == "batch_stats":
            raise ValueError(f"unknown batch statistic: {key!r}")
        arr = _to_torch_layout(leaf, np.asarray(arr, np.float32))
        state[".".join(mods + [name or leaf])] = torch.tensor(arr)
    return state


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, Mapping):
            yield from _flatten(v, key)
        else:
            yield key, np.asarray(v)


def variables_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A whole flax variables tree (``{'params': ..., 'batch_stats': ...}``,
    nested mappings of numpy arrays) -> state dict."""
    return params_from_jax(dict(_flatten(variables)))


def _to_flax_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if arr.ndim == 2:
            return arr.T
        # (O, I, k...) -> (k..., I, O)
        return arr.transpose(*range(2, arr.ndim), 1, 0)
    if leaf == "negative_slope":
        return arr.reshape(())
    return arr


def _flax_path(name: str, ndim: int):
    """A state-dict name -> (collection, module path, flax leaf)."""
    *mods, leaf = name.split(".")
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", mods, leaf[len("running_"):]
    if leaf == "bias":
        return "params", mods, leaf
    if leaf == "weight":
        if ndim >= 2:
            return "params", mods, "kernel"
        if mods and mods[-1].startswith("PReLU"):
            return "params", mods, "negative_slope"
        return "params", mods, "scale"  # BatchNorm, GroupNorm
    raise ValueError(f"no flax leaf for {name!r}")


def params_to_jax(state_dict) -> Dict[str, np.ndarray]:
    """State dict -> ``{keystr: float32 array}`` of the flax variables tree,
    in the order ``jax.tree_util.tree_flatten_with_path`` gives its leaves
    (dict keys sorted at each level): the inverse of ``params_from_jax``."""
    leaves = []
    for name, t in state_dict.items():
        arr = t.detach().to(torch.float32).cpu().numpy()
        col, mods, leaf = _flax_path(name, arr.ndim)
        leaves.append(((col, *mods, leaf), _to_flax_layout(leaf, arr)))
    leaves.sort(key=lambda kv: kv[0])
    return {"".join(f"['{p}']" for p in path): np.array(arr, order="C")
            for path, arr in leaves}
