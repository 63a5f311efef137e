"""Carry flax parameters of ``morefusion_tpu`` models over to the port.

The JAX package archives checkpoints as one npz whose keys are
``"bf16:" + keystr`` (float leaves, stored through a uint16 view) or
``"raw:" + keystr``, with keystr like ``['params']['conv3']['kernel']``.
bf16 is the upper half of fp32, so a leaf decodes exactly as
``(u16.astype(uint32) << 16).view(float32)``, with no bf16 type needed.

Layouts: conv kernels ``(k..., I, O) -> (O, I, k...)``, Dense kernels
``(I, O) -> (O, I)``, PReLU's scalar slope -> ``(1,)``. The port's modules
are named after the flax tree, so ``['params']['a']['b']['kernel']`` becomes
``a.b.weight``.
"""

from __future__ import annotations

import re
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


def params_from_jax(np_params: Dict[str, np.ndarray]):
    """``{keystr: array}`` of a flax ``{'params': ...}`` tree -> state dict."""
    state = {}
    for key, arr in np_params.items():
        path = _KEY.findall(key)
        if not path or path[0] != "params":
            raise ValueError(f"not a params leaf: {key!r}")
        *mods, leaf = path[1:]
        name = {"kernel": "weight", "negative_slope": "weight"}.get(leaf, leaf)
        arr = _to_torch_layout(leaf, np.asarray(arr, np.float32))
        state[".".join(mods + [name])] = torch.tensor(arr)
    return state
