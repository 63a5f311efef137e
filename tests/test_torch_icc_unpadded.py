"""``IterativeCollisionCheck(pad_objects=False)`` against the JAX package's.

Without padding the refiner's arrays hold the objects alone (3 and 5
here, where padding would make 4 and 8). Held as ``test_torch_icc.py``
holds the padded refine: 5 iterations at V = 8, 64 points an object, in
both cross modes: losses within 1e-5, poses within 1e-4, ``n_iter``
equal. On the CPU the unpadded refine also equals the padded one's
objective at the same poses (``loss_components``) to 1e-6.
"""

import numpy as np
import pytest
import torch

from morefusion_tpu.contrib import collision_refine as JC
from morefusion_tpu_torch.contrib import collision_refine as TC

torch.set_num_threads(2)

V = 8


def _problem(N, seed):
    rng = np.random.RandomState(seed)
    Ts = []
    for _ in range(N):
        T = np.eye(4)
        T[:3, 3] = rng.uniform(-0.02, 0.02, 3)
        Ts.append(T)
    pts = [rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
           for n in rng.randint(30, 90, N)]
    sdf = [rng.uniform(0, 0.01, len(p)).astype(np.float32) for p in pts]
    pitch = list(rng.uniform(0.009, 0.011, N))
    origin = [rng.uniform(-0.05, -0.03, 3) for _ in range(N)]
    gt = (rng.rand(N, V, V, V) * 255).astype(np.uint8)
    gn = (rng.rand(N, V, V, V) * 255).astype(np.uint8)
    return (Ts, pts, sdf, pitch, origin, gt, gn)


@pytest.mark.parametrize("cross_mode", ["resample", "exact"])
@pytest.mark.parametrize("N", [3, 5])
def test_unpadded_refine_matches_jax(N, cross_mode):
    args = _problem(N, seed=N)
    kw = dict(voxel_dim=V, max_points=64, cross_mode=cross_mode,
              pad_objects=False)
    j_T, j_l, j_n = JC.IterativeCollisionCheck(*args, **kw).refine(
        iterations=5)
    icc = TC.IterativeCollisionCheck(*args, **kw, device="cpu")
    assert icc._arrays["points"].shape == (N, 64, 3)
    assert icc._arrays["obj_mask"].all()
    t_T, t_l, t_n = icc.refine(iterations=5)
    assert t_T.shape == (N, 4, 4) and t_n == j_n
    np.testing.assert_allclose(t_l, j_l, atol=1e-5)
    np.testing.assert_allclose(t_T, j_T, atol=1e-4)


@pytest.mark.parametrize("cross_mode", ["resample", "exact"])
def test_unpadded_objective_equals_padded(cross_mode):
    """The padded slots are masked out of the loss: at the same poses both
    layouts give the same objective and parts."""
    args = _problem(5, seed=7)
    kw = dict(voxel_dim=V, max_points=64, cross_mode=cross_mode,
              device="cpu")
    padded = TC.IterativeCollisionCheck(*args, **kw)
    unpadded = TC.IterativeCollisionCheck(*args, **kw, pad_objects=False)
    assert padded._arrays["points"].shape[0] == 8
    for got, want in zip(unpadded.loss_components(),
                         padded.loss_components()):
        np.testing.assert_allclose(got, want, atol=1e-6)
