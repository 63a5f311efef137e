"""The port's pose-estimation node against ``morefusion_tpu.runtime``.

The device crop is index arithmetic and bilinear weights: the cloud crop
agrees exactly, the rgb crop to 1e-4 of its 0-255 range. The node runs a
tiny SingleView3D with flax weights (made by ``torch_to_flax`` from a
random port model) carried across by ``params_from_jax``. The JAX node
draws its pixels with jax.random under PRNGKey(1234), so the test
recomputes those indices and hands them to the port. Poses agree to 1e-5,
confidences to 1e-6 (fp32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu import models as JM
from morefusion_tpu.models.sampling import sample_mask_indices
from morefusion_tpu.runtime import pose_estimation as JP
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.runtime import pose_estimation as TP
from tests.test_torch_model import torch_to_flax

torch.set_num_threads(2)

H, W, S = 60, 80, 48
IDS = np.array([3, 7, 9], np.int32)
BBOXES = np.array([[5, 10, 30, 50], [35, 20, 55, 35], [20, 55, 40, 78]],
                  np.int32)


def _frame(rng):
    rgb = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    pcd = rng.uniform(-0.1, 0.1, (H, W, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    pcd[rng.rand(H, W) < 0.1] = np.nan
    label = np.zeros((H, W), np.int32)
    for i, (y1, x1, y2, x2) in zip(IDS, BBOXES):
        label[y1:y2, x1:x2] = i
    label[rng.rand(H, W) < 0.05] = 0
    return rgb, pcd, label


def test_crop_instance_device(rng):
    rgb, pcd, label = _frame(rng)
    t_rgb, t_pcd = TP._crop_instance_device(
        torch.from_numpy(rgb), torch.from_numpy(pcd), torch.from_numpy(label),
        torch.from_numpy(IDS), torch.from_numpy(BBOXES), S)
    for k in range(len(IDS)):
        # eager: under jit XLA contracts the bilinear weights differently
        j_rgb, j_pcd = JP._crop_instance_device(
            rgb, pcd, label, IDS[k], jnp.asarray(BBOXES[k]), S)
        np.testing.assert_allclose(t_rgb[k].numpy(), j_rgb, atol=1e-4)
        np.testing.assert_array_equal(t_pcd[k].numpy(), j_pcd)


class _Bank:
    def get_voxel_pitch(self, voxel_dim, class_id):
        return 0.004 + 0.001 * class_id


def _nodes(rng, P=16):
    torch.manual_seed(0)
    variables = torch_to_flax(
        TM.tiny_singleview3d(10, n_point=P, with_occupancy=True))
    jmodel = JM.tiny_singleview3d(10, n_point=P, with_occupancy=True)
    tmodel = TM.tiny_singleview3d(10, n_point=P, with_occupancy=True)
    flat, _ = jax.tree_util.tree_flatten_with_path(variables)
    tmodel.load_state_dict(TM.params_from_jax(
        {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}))
    jnode = JP.PoseEstimationNode(jmodel, variables, _Bank(), image_size=S)
    tnode = TP.PoseEstimationNode(tmodel, _Bank().get_voxel_pitch,
                                  image_size=S, device="cpu")
    return jnode, tnode


def test_pose_estimation_node_estimate(rng):
    rgb, pcd, label = _frame(rng)
    inst = {3: 2, 7: 5, 9: 8, 11: 1}  # 11 is not in the frame
    grids = {3: rng.rand(32, 32, 32).astype(np.float32),
             9: (rng.rand(32, 32, 32) * 255).astype(np.uint8)}
    jnode, tnode = _nodes(rng)
    want = jnode.estimate(rgb, pcd, label, inst, grids)
    # the JAX node's draw: its crops, padded to 4 with instance 0
    crop = jax.jit(JP._crop_instance_device, static_argnums=5)
    crops = [crop(rgb, pcd, label, IDS[k], BBOXES[k], S)
             for k in (0, 1, 2, 0)]
    mask = jnp.stack([~jnp.any(jnp.isnan(c[1]), -1) for c in crops])
    idx = np.asarray(sample_mask_indices(mask, jax.random.PRNGKey(1234), 16))
    got = tnode.estimate(rgb, pcd, label, inst, grids,
                         sample_indices=dict(zip(IDS.tolist(), idx[:3])))
    assert sorted(got) == sorted(want) == [3, 7, 9]
    for i in want:
        assert got[i]["class_id"] == want[i]["class_id"]
        np.testing.assert_allclose(got[i]["T_cad2cam"],
                                   want[i]["T_cad2cam"], atol=1e-5)
        np.testing.assert_allclose(got[i]["confidence"],
                                   want[i]["confidence"], atol=1e-6)
    # the default draw: seeded, so the same frame gives the same poses
    a = tnode.estimate(rgb, pcd, label, inst, grids)
    b = tnode.estimate(rgb, pcd, label, inst, grids)
    for i in a:
        np.testing.assert_array_equal(a[i]["T_cad2cam"], b[i]["T_cad2cam"])


def test_node_with_no_instance_returns_nothing(rng):
    rgb, pcd, label = _frame(rng)
    _, tnode = _nodes(rng)
    assert tnode.estimate(rgb, pcd, label, {42: 1}) == {}


def test_node_defaults_to_the_card(rng):
    """Without ``device=`` the node goes to CUDA; with no card that fails
    rather than falling back to the CPU."""
    model = TM.tiny_singleview3d(3, n_point=8)
    if torch.cuda.is_available():
        node = TP.PoseEstimationNode(model, _Bank().get_voxel_pitch)
        assert node._device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            TP.PoseEstimationNode(model, _Bank().get_voxel_pitch)
