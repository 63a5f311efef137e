"""``functions.knn.nn`` (``geometry.nn``) in both of its forms against JAX.

JAX's ``nn(ref (R, D), query (Q, D)) -> (Q,)`` is called as it is, beside
the port's 2-D call on the same float32 points; the port's batched form
``(B, R, 3), (B, Q, 3) -> (B, Q)`` must give the lanes' 2-D answers. JAX's
``|q|^2 + |r|^2 - 2 q.r`` search is patched to the exact sum of squares
(``test_torch_geometry_rest.py``), so the indices are equal.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu import geometry as JG
from morefusion_tpu.functions import knn as jknn
from morefusion_tpu_torch import geometry as TG
from morefusion_tpu_torch.functions import knn as tknn
from tests.test_torch_geometry_rest import _exact_pairwise

torch.set_num_threads(2)


@pytest.mark.parametrize("R,Q", [(1, 5), (50, 300), (500, 2000)])
def test_two_dimensional_call_matches_jax(R, Q):
    rng = np.random.RandomState(R + Q)
    ref = (rng.normal(0, 0.05, (R, 3)) + [0, 0, 0.8]).astype(np.float32)
    query = (rng.normal(0, 0.05, (Q, 3)) + [0, 0, 0.8]).astype(np.float32)
    with mock.patch.object(jknn, "pairwise_sq_dist", _exact_pairwise):
        want = np.asarray(JG.nn(jnp.asarray(ref), jnp.asarray(query)))
    for fn in (TG.nn, tknn.nn):
        got = fn(torch.from_numpy(ref), torch.from_numpy(query))
        assert got.shape == (Q,) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_batched_form_is_its_lanes_two_dimensional_calls():
    rng = np.random.RandomState(7)
    ref = torch.from_numpy(rng.normal(size=(3, 40, 3)).astype(np.float32))
    query = torch.from_numpy(rng.normal(size=(3, 90, 3)).astype(np.float32))
    got = TG.nn(ref, query)
    assert got.shape == (3, 90) and got.dtype == torch.int32
    for b in range(3):
        assert torch.equal(got[b], TG.nn(ref[b], query[b]))


def test_float32_and_three_coordinates_are_required():
    ref = torch.zeros(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        TG.nn(ref, ref)
    with pytest.raises(ValueError, match="float32"):
        TG.nn(torch.zeros(4, 2), torch.zeros(5, 2))
