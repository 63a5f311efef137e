"""Small constant tensors on a device, made once.

A tensor built from host values on a card (``torch.tensor(values,
device=...)``) is a copy from pageable memory, and such a copy waits for
every operation queued on the current stream. Inside a forward that stops
the host until the card has caught up, so the host cannot enqueue ahead of
the card. :func:`device_constant` makes each constant at its first use and
keeps it; callers must not write to it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (a number, a nested sequence or an array) as a ``dtype``
    tensor on ``device``, the same tensor at every call with equal values
    (the latest 256 kept)."""
    return _made(_frozen(np.asarray(values).tolist()), dtype,
                 torch.device(device))


def _frozen(values):
    if isinstance(values, list):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=256)
def _made(values, dtype, device):
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
