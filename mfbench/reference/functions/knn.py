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
    """Index into ``ref`` of the nearest neighbour of each point of
    ``query``, the lowest index on a tie; no gradient flows through the
    indices. Two forms, both float32 with 3 coordinates:

    - JAX's, ``ref (R, 3)`` and ``query (Q, 3)`` -> ``(Q,)`` int32: run as
      one lane of the batched form;
    - batched over lanes, ``ref (B, R, 3)`` and ``query (B, Q, 3)`` ->
      ``(B, Q)`` int32.
    """
    if ref.dim() == 2 and query.dim() == 2:
        return nn(ref[None], query[None])[0]
    with torch.no_grad():
        return _knn_ops.nn_indices(ref.detach().contiguous(),
                                   query.detach().contiguous())
