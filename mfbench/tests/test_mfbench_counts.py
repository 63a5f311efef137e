"""The yardstick's counts at fixed shapes."""

import math

import torch

from mfbench import counts


def test_knn_work_at_the_train_shape():
    # 16 lanes x 500,000 queries x 500 CAD points: chip_smoke.py's bound
    ops, nbytes = counts.knn_work(16, 500, 500_000)
    assert ops == 8 * 16 * 500_000 * 500
    assert nbytes == 16 * (500_000 + 500) * 12 + 16 * 500_000 * 4
    assert math.isclose(counts.least_seconds(ops, nbytes) * 1e3,
                        0.47761194029850745, rel_tol=1e-12)


def test_min_dist_work_is_the_separable_count():
    ops, nbytes = counts.min_dist_work(8, 2048, (32, 32, 32), 10_000)
    assert ops == 10_000 * (2 * 32768 + 2 * 96 + 32 * 32)
    assert nbytes == 8 * 2048 * 17 + 8 * 32768 * 12
    # operations bound it at this shape
    assert counts.least_seconds(ops, nbytes) == ops / counts.PEAK_FP32_FLOPS
    ops, _ = counts.min_dist_work(2, 5, (2, 3, 4), 3)
    assert ops == 3 * (2 * 24 + 2 * 9 + 6)


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(67e12, 0) == 1.0
    assert counts.least_seconds(1.0, 3.35e12) == 1.0


def test_count_flops_counts_matrix_products():
    a, b = torch.randn(3, 5), torch.randn(5, 7)
    assert counts.count_flops(lambda: a @ b) == 2 * 3 * 5 * 7
    w = torch.randn(4, 2, 3, 3, requires_grad=True)
    x = torch.randn(1, 2, 6, 6)

    def conv():
        torch.nn.functional.conv2d(x, w).sum().backward()

    forward = 2 * 4 * 2 * 9 * 16
    # the backward's weight gradient costs as much again (no input grad)
    assert counts.count_flops(conv) == 2 * forward
