"""Nearest-neighbour indices, batched over lanes.

Port of ``morefusion_tpu/functions/knn.py::nn``. The JAX function forms
``|q|^2 + |r|^2 - 2 q.r`` for the MXU; the port takes the direct sum of
squares of ``ops/knn.py`` (the CUDA kernel on the card, its plain version on
the CPU), so at a near-tie the two may pick different points at the same
distance to float32 rounding.
"""

from __future__ import annotations

import torch

from ..ops import knn as _knn_ops


def nn(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Index into ``ref (B, R, 3)`` of the nearest neighbour of each point
    of ``query (B, Q, 3)``: ``(B, Q)`` int32, the lowest index on a tie. No
    gradient flows through the indices."""
    with torch.no_grad():
        return _knn_ops.nn_indices(ref.detach().contiguous(),
                                   query.detach().contiguous())
