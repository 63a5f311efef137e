"""The port's ICP against ``morefusion_tpu.contrib.icp`` on the CPU.

Same float32 inputs, made from a seed with numpy, through both packages:
procedural CAD clouds (``ProceduralModels``, identical in both) under a
random pose, the observed cloud the same points under that pose, and the
start pose off by a few degrees and millimetres.

JAX's ICP searches with ``pairwise_sq_dist``, the float32 expansion
``|a|^2 + |b|^2 - 2 a.b``; the port with the exact sum of squares
``(dx*dx + dy*dy) + dz*dz``. Where the two are compared, JAX's search is
patched to that exact sum (``_jax_exact_search``), so both pick the same
correspondences, gate the same pairs and stop after the same iteration. The
jitted JAX functions are traced afresh inside the patch (``jax.clear_caches``
on entry and exit), so that no trace of either kind leaks into another test.
The cases keep every correspondence clear of the 2 cm gate and the RMSE stop
clear of its threshold: ``n_iterations`` must be equal.

Tolerances (float32 on both sides, sums in other orders):
- ``_masked_kabsch``: R and t within 1e-5 (m for t);
- ICP poses (fixed 5 and 30 iterations, gated, ``register`` and
  ``register_iterative``): every entry within 1e-5, ``n_iterations`` equal;
- the reference unpatched, at 0.8 m: every entry within 1e-4 and
  ``n_iterations`` within 1 of the port (the expansion's rounding, ~1e-7 m^2
  at |q|^2 ~ 0.64, against d2 ~ 1e-5 m^2, may move a near-tie and the RMSE
  that the stop compares);
- ``gradient_icp``: each step's loss within 1e-4 relative plus 1e-7 m^2,
  the final quaternion and translation within 1e-5. Adam's updates round
  differently in the two frameworks, so the quaternions drift a few float32
  ulps apart (~2e-7), which moves CAD points 0.1 m from the model's origin
  by ~4e-8 m; at the late steps (residuals ~0.4 mm over 500 points, loss
  < 1e-4 m^2) that changes the loss by up to 2 sqrt(n L) |dr| ~ 3e-8 m^2,
  above 1e-4 of it;
- ``voxel_down_sample``: identical arrays; ``pairwise_sq_dist``: within 2^-21
  of ``|a|^2 + |b|^2`` (the expansion's own rounding);
- the pose node with ICP: poses within 1e-5 of the JAX node's.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.transform
import torch

from morefusion_tpu.contrib import icp as jicp
from morefusion_tpu.datasets import ProceduralModels as JProceduralModels
from morefusion_tpu.functions import knn as jknn
from morefusion_tpu.geometry import pointcloud as jpointcloud
from morefusion_tpu.geometry.transform import quaternion_from_matrix
from morefusion_tpu_torch import contrib as tcontrib
from morefusion_tpu_torch import geometry as tgeometry
from morefusion_tpu_torch.contrib import icp as ticp
from morefusion_tpu_torch.datasets import ProceduralModels
from morefusion_tpu_torch.functions import knn as tknn

torch.set_num_threads(2)

T_ATOL = 1e-5


def _exact_pairwise(a, b):
    d = a[:, None, :] - b[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


@contextlib.contextmanager
def _jax_exact_search():
    jax.clear_caches()
    try:
        with mock.patch.object(jicp, "pairwise_sq_dist", _exact_pairwise):
            yield
    finally:
        jax.clear_caches()


def _perturbation(g, deg, trans):
    axis = g.normal(size=3)
    axis /= np.linalg.norm(axis)
    P = np.eye(4)
    P[:3, :3] = scipy.spatial.transform.Rotation.from_rotvec(
        np.radians(deg) * axis).as_matrix()
    P[:3, 3] = g.uniform(-trans, trans, 3)
    return P


def _scene(seed, class_id, n=800, z=0.5, noise=0.0, deg=6.0, trans=0.008):
    """``(cad, depth, T_true, T_init)``: ``n`` CAD points, the same points
    under a random pose ``z`` m from the camera (plus ``noise`` m of
    Gaussian noise), and that pose perturbed by ``deg`` and ``trans``."""
    g = np.random.RandomState(seed)
    cad = ProceduralModels().get_pcd(class_id)[:n].astype(np.float32)
    T_true = np.eye(4)
    T_true[:3, :3] = scipy.spatial.transform.Rotation.random(
        random_state=g).as_matrix()
    T_true[:3, 3] = [0.0, 0.0, z]
    depth = (cad @ T_true[:3, :3].T + T_true[:3, 3]
             + g.normal(0, noise, cad.shape)).astype(np.float32)
    return cad, depth, T_true, T_true @ _perturbation(g, deg, trans)


SEEDS = [(0, 2), (1, 5), (2, 13)]  # (seed, class): box, bottle, bowl


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("case", ["random", "binary", "reflection", "zeros"])
def test_masked_kabsch_matches_jax(case):
    g = np.random.RandomState(len(case))
    src = g.normal(0, 0.05, (300, 3)).astype(np.float32)
    R_true = scipy.spatial.transform.Rotation.random(
        random_state=g).as_matrix()
    dst = src @ R_true.T + [0.01, -0.02, 0.5] + g.normal(0, 1e-3, src.shape)
    w = g.rand(300)
    if case == "binary":
        w = (w > 0.3).astype(np.float64)
    if case == "reflection":
        # the best orthogonal fit is a mirror: both return a rotation
        dst = src * [-1.0, 1.0, 1.0]
    if case == "zeros":
        w = np.zeros(300)
    dst, w = _f32(dst), _f32(w)
    R_j, t_j = jicp._masked_kabsch(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(w))
    R_t, t_t = ticp._masked_kabsch(torch.from_numpy(src),
                                   torch.from_numpy(dst), torch.from_numpy(w))
    assert R_t.dtype == torch.float32 and np.asarray(R_j).dtype == np.float32
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=T_ATOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=T_ATOL)
    np.testing.assert_allclose(np.linalg.det(R_t.numpy()), 1.0, atol=1e-5)
    if case == "zeros":
        np.testing.assert_array_equal(R_t.numpy(), np.eye(3))
        np.testing.assert_array_equal(t_t.numpy(), np.zeros(3))
    if case == "random":
        np.testing.assert_allclose(R_t.numpy(), R_true, atol=1e-3)


@pytest.mark.parametrize("iterations", [5, 30])
@pytest.mark.parametrize("seed,class_id", SEEDS)
def test_icp_point_to_point_matches_jax(seed, class_id, iterations):
    cad, depth, _, T_init = _scene(seed, class_id)
    with _jax_exact_search():
        T_j = jicp.icp_point_to_point(
            jnp.asarray(cad), jnp.asarray(depth), jnp.asarray(_f32(T_init)),
            max_correspondence_distance=0.02, iterations=iterations)
    T_t = ticp.icp_point_to_point(
        torch.from_numpy(cad), torch.from_numpy(depth),
        torch.from_numpy(_f32(T_init)), max_correspondence_distance=0.02,
        iterations=iterations)
    assert np.asarray(T_j).dtype == np.float32
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=T_ATOL)


@pytest.mark.parametrize("seed,class_id", SEEDS)
def test_icp_gated_matches_jax(seed, class_id):
    cad, depth, T_true, T_init = _scene(seed, class_id, noise=0.001)
    with _jax_exact_search():
        T_j, n_j = jicp.icp_point_to_point_gated(
            jnp.asarray(cad), jnp.asarray(depth), jnp.asarray(_f32(T_init)),
            max_correspondence_distance=0.02, max_iterations=100)
    T_t, n_t = ticp.icp_point_to_point_gated(
        torch.from_numpy(cad), torch.from_numpy(depth),
        torch.from_numpy(_f32(T_init)), max_correspondence_distance=0.02,
        max_iterations=100)
    assert n_t == int(n_j) < 100
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=T_ATOL)
    # and it converged onto the true pose
    np.testing.assert_allclose(T_t.numpy(), T_true, atol=5e-3)


def test_gated_searches_once_an_iteration():
    cad, depth, _, T_init = _scene(0, 2)
    calls = []
    search = ticp._knn_ops.nn_indices

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return search(*args, **kwargs)

    with mock.patch.object(ticp._knn_ops, "nn_indices", counted):
        _, n = ticp.icp_point_to_point_gated(
            torch.from_numpy(cad), torch.from_numpy(depth),
            torch.from_numpy(_f32(T_init)))
    assert len(calls) == n and all(c == {"return_d2": True} for c in calls)


@pytest.mark.parametrize("seed,class_id", SEEDS)
def test_icp_registration_matches_jax(seed, class_id):
    """``register`` (defaults: 100 iterations, voxel 0.01) and 10 steps of
    ``register_iterative``: the JAX wrapper pads both clouds with sentinels,
    the port does not, and the poses agree."""
    cad, depth, _, T_init = _scene(seed, class_id, n=4000, noise=0.001)
    with _jax_exact_search():
        j_reg = jicp.ICPRegistration(depth, cad, T_init)
        T_j = j_reg.register()
        j_steps = list(jicp.ICPRegistration(depth, cad, T_init)
                       .register_iterative(iteration=10))
    t_reg = ticp.ICPRegistration(depth, cad, T_init, device="cpu")
    T_t = t_reg.register()
    t_steps = list(ticp.ICPRegistration(depth, cad, T_init, device="cpu")
                   .register_iterative(iteration=10))
    assert T_t.dtype == np.float64 and T_t.shape == (4, 4)
    assert t_reg.last_n_iterations == int(j_reg.last_n_iterations)
    np.testing.assert_allclose(T_t, T_j, atol=T_ATOL)
    assert len(t_steps) == len(j_steps) == 11
    np.testing.assert_array_equal(t_steps[0], T_init)
    for a, b in zip(t_steps, j_steps):
        np.testing.assert_allclose(a, b, atol=T_ATOL)


def test_icp_registration_against_the_unpatched_reference():
    """A record of the reference's precision: JAX's expansion as it is, at
    0.8 m from the camera, against the port's exact search."""
    cad, depth, _, T_init = _scene(3, 19, n=4000, z=0.8, noise=0.001)
    jax.clear_caches()  # no exact-search trace of another test
    j_reg = jicp.ICPRegistration(depth, cad, T_init)
    T_j = j_reg.register()
    t_reg = ticp.ICPRegistration(depth, cad, T_init, device="cpu")
    T_t = t_reg.register()
    assert abs(t_reg.last_n_iterations - int(j_reg.last_n_iterations)) <= 1
    np.testing.assert_allclose(T_t, T_j, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_gradient_icp_matches_jax(seed):
    cad, depth, _, T_init = _scene(seed, 4, n=500, deg=5, trans=0.005)
    q0 = _f32(quaternion_from_matrix(T_init))
    t0 = _f32(T_init[:3, 3])
    with _jax_exact_search():
        q_j, t_j, loss_j = jicp.gradient_icp(
            jnp.asarray(cad), jnp.asarray(depth), jnp.asarray(q0),
            jnp.asarray(t0), iterations=60)
    q_t, t_t, loss_t = ticp.gradient_icp(
        torch.from_numpy(cad), torch.from_numpy(depth), torch.from_numpy(q0),
        torch.from_numpy(t0), iterations=60)
    loss_j = np.asarray(loss_j)
    assert loss_t.shape == (60,) and loss_j.dtype == np.float32
    np.testing.assert_allclose(loss_t.numpy(), loss_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=T_ATOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=T_ATOL)
    assert loss_j[-1] < 0.5 * loss_j[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_voxel_down_sample_matches_jax(dtype):
    g = np.random.RandomState(7)
    points = g.uniform(-0.1, 0.1, (3000, 3)).astype(dtype)
    points[g.choice(3000, 200, replace=False), g.randint(3)] = np.nan
    got = tgeometry.voxel_down_sample(points, 0.01)
    want = jpointcloud.voxel_down_sample(points, 0.01)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    all_nan = np.full((5, 3), np.nan, dtype)
    assert tgeometry.voxel_down_sample(all_nan, 0.01).shape == (0, 3)


def test_pairwise_sq_dist_matches_jax():
    g = np.random.RandomState(8)
    a = (g.uniform(-0.1, 0.1, (200, 3)) + [0, 0, 0.8]).astype(np.float32)
    b = (g.uniform(-0.1, 0.1, (300, 3)) + [0, 0, 0.8]).astype(np.float32)
    got = tknn.pairwise_sq_dist(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jknn.pairwise_sq_dist(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = (a.astype(np.float64) ** 2).sum(1)[:, None] \
        + (b.astype(np.float64) ** 2).sum(1)[None]
    assert (np.abs(got.numpy() - want) <= 2.0**-21 * scale).all()
    assert (got.numpy() >= 0).all()


def test_contrib_exports():
    for name in ("ICPRegistration", "icp_point_to_point",
                 "icp_point_to_point_gated", "gradient_icp"):
        assert getattr(tcontrib, name) is getattr(ticp, name)


def test_procedural_cad_points_match_jax():
    """The node tests hand both packages their own bank's CAD points."""
    for class_id in (2, 5, 13):
        np.testing.assert_array_equal(
            ProceduralModels().get_pcd(class_id),
            JProceduralModels().get_pcd(class_id))


@pytest.mark.cuda
def test_icp_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from morefusion_tpu_torch.ops import knn as ops_knn

    cad, depth, _, T_init = _scene(0, 2, n=4000, noise=0.001)
    before = ops_knn.nn_indices.launches
    card = ticp.ICPRegistration(depth, cad, T_init, device="cuda")
    T_card = card.register()
    assert ops_knn.nn_indices.launches - before == card.last_n_iterations
    cpu = ticp.ICPRegistration(depth, cad, T_init, device="cpu")
    T_cpu = cpu.register()
    assert card.last_n_iterations == cpu.last_n_iterations
    np.testing.assert_allclose(T_card, T_cpu, atol=1e-4)


def test_pose_node_with_icp_matches_jax(rng):
    """The port's node with ICP against the JAX node with ICP: the tiny
    model and the frame of ``test_torch_node.py``, the JAX node's pixel draw
    handed to the port, CAD points from each package's procedural bank."""
    from morefusion_tpu.models.sampling import sample_mask_indices
    from morefusion_tpu.runtime import pose_estimation as JP
    from morefusion_tpu_torch.runtime import pose_estimation as TP
    from tests.test_torch_node import BBOXES, IDS, S, _Bank, _frame, _nodes

    class _JaxBank(_Bank):
        def get_pcd(self, class_id):
            return JProceduralModels().get_pcd(class_id)

    rgb, pcd, label = _frame(rng)
    inst = {3: 2, 7: 5, 9: 8}
    jnode, tnode = _nodes(rng)
    jnode = JP.PoseEstimationNode(jnode._model, jnode._params, _JaxBank(),
                                  image_size=S, with_icp=True)
    tnode = TP.PoseEstimationNode(tnode._model, _Bank().get_voxel_pitch,
                                  image_size=S, device="cpu", with_icp=True,
                                  cad_points=ProceduralModels().get_pcd)
    crop = jax.jit(JP._crop_instance_device, static_argnums=5)
    crops = [crop(rgb, pcd, label, IDS[k], BBOXES[k], S)
             for k in (0, 1, 2, 0)]
    mask = jnp.stack([~jnp.any(jnp.isnan(c[1]), -1) for c in crops])
    idx = np.asarray(sample_mask_indices(mask, jax.random.PRNGKey(1234), 16))
    with _jax_exact_search():
        want = jnode.estimate(rgb, pcd, label, inst)
    got = tnode.estimate(rgb, pcd, label, inst,
                         sample_indices=dict(zip(IDS.tolist(), idx[:3])))
    assert sorted(got) == sorted(want) == [3, 7, 9]
    assert sorted(tnode.last_icp_iterations) == [3, 7, 9]
    assert max(tnode.last_icp_iterations.values()) > 1  # ICP moved poses
    for i in want:
        np.testing.assert_allclose(got[i]["T_cad2cam"], want[i]["T_cad2cam"],
                                   atol=T_ATOL)


def test_pose_node_with_icp_needs_cad_points():
    from morefusion_tpu_torch import models as TM
    from morefusion_tpu_torch.runtime import PoseEstimationNode

    with pytest.raises(ValueError):
        PoseEstimationNode(TM.tiny_singleview3d(3, n_point=8),
                           lambda voxel_dim, class_id: 0.01, device="cpu",
                           with_icp=True)
