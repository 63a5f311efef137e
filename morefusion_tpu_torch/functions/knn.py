"""Nearest-neighbour indices, batched over lanes, and pairwise distances.

Port of ``morefusion_tpu/functions/knn.py``. The JAX ``nn`` forms
``|q|^2 + |r|^2 - 2 q.r`` for the MXU; the port's :func:`nn` takes the
direct sum of squares of ``ops/knn.py`` (the CUDA kernel on the card, its
plain version on the CPU), so at a near-tie the two may pick different
points at the same distance to float32 rounding. :func:`pairwise_sq_dist`
keeps the JAX expansion; no search of the port uses it.
"""

from __future__ import annotations

import torch

from ..ops import knn as _knn_ops


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances ``(N, M)`` between the rows of ``a (N, D)``
    and ``b (M, D)``, as ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0."""
    a2 = torch.sum(a * a, dim=-1)[:, None]
    b2 = torch.sum(b * b, dim=-1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def nn(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Index into ``ref (B, R, 3)`` of the nearest neighbour of each point
    of ``query (B, Q, 3)``: ``(B, Q)`` int32, the lowest index on a tie. No
    gradient flows through the indices."""
    with torch.no_grad():
        return _knn_ops.nn_indices(ref.detach().contiguous(),
                                   query.detach().contiguous())
