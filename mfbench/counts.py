"""The benchmark's yardstick: the card's peaks, the work the two kernels'
inputs need, and the FLOPs of a model's step.

The counts read the work the inputs need, whatever implements it: the same
count stands against the CUDA kernel today and against any later kernel.
``min_dist_work`` and ``knn_work`` are ``chip_smoke.py::min_dist_bound`` and
``knn_bound``, copied; the FLOP count is ``cli/profile_train.py``'s method
(``FlopCounterMode``), run on the reference model so that it counts the
model's convolutions and matrix products and nothing the port launches
through ``ctypes``.
"""

from __future__ import annotations


# one NVIDIA H100 SXM (data sheet, at its 700 W limit): fp32 outside the
# tensor cores (TF32 is off in every configuration), HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KNN_FLOPS_PER_PAIR = 8  # 3 sub, 3 mul, 2 add per query-reference pair


def least_seconds(ops: float, bytes_moved: float) -> float:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the memory rate."""
    return max(ops / PEAK_FP32_FLOPS, bytes_moved / PEAK_BYTES_PER_S)


def min_dist_work(B: int, P: int, dims, n_valid: int):
    """``(operations, bytes)`` of one min-distance call on ``B`` lanes of
    ``P`` points, ``n_valid`` of them valid and finite, over a grid of
    ``dims``: the separable sum (for each valid point a subtraction and a
    square per distinct i, j and k, one add per (i, j), one add and one min
    per voxel); each input byte read once (points, mask, payload) and each
    output written once (d2, index, payload)."""
    X, Y, Z = dims
    V = X * Y * Z
    ops = n_valid * (2 * V + 2 * (X + Y + Z) + X * Y)
    bytes_moved = B * P * (3 * 4 + 1 + 4) + B * V * (4 + 4 + 4)
    return ops, bytes_moved


def knn_work(B: int, R: int, Q: int, with_d2: bool = False):
    """``(operations, bytes)`` of one nearest-neighbour call: every
    query-reference pair at 8 fp32 flops; the inputs read once and the
    indices (and the winners' d2) written once."""
    ops = KNN_FLOPS_PER_PAIR * B * Q * R
    bytes_moved = B * (Q + R) * 3 * 4 + B * Q * (8 if with_d2 else 4)
    return ops, bytes_moved


def count_flops(fn) -> int:
    """Floating-point operations of the convolutions and matrix products
    that ``fn()`` runs (forward, and backward where ``fn`` runs one)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())

