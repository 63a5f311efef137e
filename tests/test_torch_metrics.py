"""The port's metrics against ``morefusion_tpu.metrics`` (NumPy on both
sides).

ADD is the same NumPy arithmetic: identical. ADD-S: the JAX package finds
the nearest points with ``sklearn.neighbors.KDTree``, the port with
``scipy.spatial.cKDTree``; both searches are exact, so the means agree
within 1e-12 (a tie may pick another point at the same distance, whose norm
NumPy may round in another last bit). The AUCs: the VOCap formula is the
same code, and the trapezoid rule of ``auc_for_errors`` is what
``sklearn.metrics.auc`` computes: within 1e-12, on the JAX tests' reference
values (``tests/metrics_tests/test_metrics.py``) and on random errors.
"""

import numpy as np
import pytest
import scipy.spatial.transform
import torch

from morefusion_tpu import metrics as jmetrics
from morefusion_tpu_torch import metrics as tmetrics

torch.set_num_threads(2)


def _pose(g, trans=0.1):
    T = np.eye(4)
    T[:3, :3] = scipy.spatial.transform.Rotation.random(
        random_state=g).as_matrix()
    T[:3, 3] = g.uniform(-trans, trans, 3) + [0, 0, 0.8]
    return T


@pytest.mark.parametrize("translate", [True, False])
def test_average_distance_matches_jax(translate):
    g = np.random.RandomState(int(translate))
    points = [g.uniform(-0.05, 0.05, (n, 3)) for n in (100, 500, 1)]
    # exact ties for ADD-S: integer points, each twice
    ties = g.randint(-3, 4, (50, 3)).astype(np.float64) * 0.01
    points.append(np.concatenate([ties, ties]))
    T1 = [_pose(g) for _ in points]
    T2 = [_pose(g) for _ in points]
    T2[-1] = T1[-1]  # the tie case: every point matches itself twice
    got = tmetrics.average_distance(points, T1, T2, translate=translate)
    want = jmetrics.average_distance(points, T1, T2, translate=translate)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    assert (got[1] <= got[0] + 1e-12).all()


def test_average_distance_identity_and_translation():
    g = np.random.RandomState(3)
    points = g.uniform(-0.05, 0.05, (100, 3))
    T2 = np.eye(4)
    T2[:3, 3] = [0.03, 0.0, 0.0]
    adds, add_ss = tmetrics.average_distance([points, points],
                                             [np.eye(4)] * 2, [np.eye(4), T2])
    assert adds[0] == 0.0 and add_ss[0] == 0.0
    assert adds[1] == pytest.approx(0.03, abs=1e-12)
    assert add_ss[1] <= adds[1]


AUC_CASES = {
    "uniform": np.linspace(0, 0.0999, 1000),
    "half_failed": np.r_[np.zeros(50), np.full(50, 1.0)],
    "all_zero": np.zeros(100),
    "all_over": np.full(100, 0.5),
    "random": np.random.RandomState(0).uniform(0, 0.2, 500),
    "one": np.array([0.03]),
}


@pytest.mark.parametrize("case", AUC_CASES)
def test_ycb_video_add_auc_matches_jax(case):
    errors = AUC_CASES[case]
    auc, x, y = tmetrics.ycb_video_add_auc(errors, return_xy=True)
    auc_j, x_j, y_j = jmetrics.ycb_video_add_auc(errors, return_xy=True)
    assert abs(auc - auc_j) <= 1e-12
    np.testing.assert_array_equal(x, x_j)
    np.testing.assert_array_equal(y, y_j)
    if case in ("uniform", "half_failed"):
        assert auc == pytest.approx(0.5, abs=0.01)
    if case == "all_zero":
        assert auc == pytest.approx(1.0)
    if case == "all_over":
        assert auc == 0


@pytest.mark.parametrize("case", [c for c in AUC_CASES if c != "one"])
@pytest.mark.parametrize("max_threshold", [0.1, 0.02])
def test_auc_for_errors_matches_jax(case, max_threshold):
    errors = AUC_CASES[case]
    auc, x, y = tmetrics.auc_for_errors(errors, max_threshold,
                                        return_xy=True)
    auc_j, x_j, y_j = jmetrics.auc_for_errors(errors, max_threshold,
                                              return_xy=True)
    assert abs(auc - auc_j) <= 1e-12
    np.testing.assert_array_equal(x, x_j)
    np.testing.assert_array_equal(y, y_j)


def test_auc_for_errors_matches_ycb_shape():
    errors = AUC_CASES["random"]
    assert tmetrics.auc_for_errors(errors, max_threshold=0.1) == \
        pytest.approx(tmetrics.ycb_video_add_auc(errors), abs=0.02)
