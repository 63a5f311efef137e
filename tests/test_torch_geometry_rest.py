"""The rest of the port's ``geometry`` against ``morefusion_tpu.geometry``.

The host helpers are NumPy in both packages and must be equal bit for
bit: ``get_aabb_from_points``, ``uniform_points_on_sphere``,
``project_to_camera``, ``to_opengl_transform`` / ``from_opengl_transform``,
``estimate_pointcloud_normals`` (organized, with NaN holes, and
unorganized), ``trajectory.sort_by`` and ``VoxelMapping``. ``geometry.nn``
(the port's batched knn: its plain version here) is held to JAX's ``nn``
with JAX's distance patched to the port's exact sum of squares, so the
indices must be identical.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morefusion_tpu import geometry as JG
from morefusion_tpu.functions import knn as jknn
from morefusion_tpu_torch import geometry as TG

torch.set_num_threads(2)


def equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_public_names_match_jax():
    names = [n for n in dir(JG) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(TG, n)]
    assert not missing


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_aabb_from_points(seed):
    rng = np.random.RandomState(seed)
    main = rng.normal(0, 0.03, (400, 3)) + [0.1, -0.05, 0.7]
    stray = rng.normal(0, 0.01, (40, 3)) + [0.4, 0.3, 1.2]
    pts = np.concatenate([main, stray, [[np.nan, 0, 0]]])
    for g, w in zip(TG.get_aabb_from_points(pts),
                    JG.get_aabb_from_points(pts)):
        equal(g, w)
    one = np.array([[0.1, 0.2, 0.3]])
    for g, w in zip(TG.get_aabb_from_points(one),
                    JG.get_aabb_from_points(one)):
        equal(g, w)


@pytest.mark.parametrize("n,radius", [(5, 1.0), (10, 0.5), (33, 2.5)])
def test_uniform_points_on_sphere(n, radius):
    equal(TG.uniform_points_on_sphere(n, radius),
          JG.uniform_points_on_sphere(n, radius))


def test_project_to_camera_and_opengl():
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.3, 0.3, (200, 3)) + [0, 0, 0.8]
    for shape in (None, (240, 320)):
        for g, w in zip(
                TG.project_to_camera(pts, 500.0, 510.0, 160.0, 120.0, shape),
                JG.project_to_camera(pts, 500.0, 510.0, 160.0, 120.0,
                                     shape)):
            equal(g, w)
    with pytest.raises(ValueError):
        TG.project_to_camera(pts[0], 1.0, 1.0, 0.0, 0.0)
    T = rng.normal(size=(4, 4))
    for fn in ("to_opengl_transform", "from_opengl_transform"):
        equal(getattr(TG, fn)(), getattr(JG, fn)())
        equal(getattr(TG, fn)(T), getattr(JG, fn)(T))
    equal(TG.from_opengl_transform(TG.to_opengl_transform(T)), T)


def _organized(seed, H=20, W=24):
    rng = np.random.RandomState(seed)
    depth = (0.8 + 0.1 * np.sin(np.arange(W) / 3.0)[None]
             + 0.05 * rng.rand(H, W)).astype(np.float32)
    depth[rng.rand(H, W) < 0.1] = np.nan
    return TG.pointcloud_from_depth(depth, 60.0, 60.0, W / 2, H / 2)


def test_normals_organized():
    pcd = _organized(4)
    with np.errstate(invalid="ignore", divide="ignore"):
        equal(TG.estimate_pointcloud_normals(pcd),
              JG.estimate_pointcloud_normals(pcd))


def test_normals_unorganized_and_bad_shape():
    pcd = _organized(5).reshape(-1, 3)
    equal(TG.estimate_pointcloud_normals(pcd),
          JG.estimate_pointcloud_normals(pcd))
    with pytest.raises(ValueError):
        TG.estimate_pointcloud_normals(np.zeros(3))


def test_sort_by():
    rng = np.random.RandomState(6)
    pts = rng.normal(size=(30, 3))
    key = pts[rng.permutation(30)] + rng.normal(0, 0.01, (30, 3))
    equal(TG.trajectory.sort_by(pts, key), JG.trajectory.sort_by(pts, key))
    equal(TG.trajectory.sort_by(pts.astype(np.float32), key),
          JG.trajectory.sort_by(pts.astype(np.float32), key))
    with pytest.raises(ValueError):
        TG.trajectory.sort_by(pts, key[:-1])


def test_voxel_mapping():
    rng = np.random.RandomState(7)
    maps = [M(origin=np.array([-0.1, -0.1, 0.5]), pitch=0.01, voxel_dim=20,
              nchannel=3) for M in (TG.VoxelMapping, JG.VoxelMapping)]
    for k in range(3):
        pts = rng.uniform(-0.12, 0.12, (300, 3)) + [0, 0, 0.6]
        vals = rng.randint(0, 255, (300, 3)).astype(np.float64)
        for m in maps:
            m.add(pts, vals)
    maps[0].add(np.full((2, 3), 9.0), np.zeros((2, 3)))  # all outside
    maps[1].add(np.full((2, 3), 9.0), np.zeros((2, 3)))
    got, want = maps
    equal(got.matrix, want.matrix)
    equal(got.values, want.values)
    equal(got.voxel_bbox_extents, want.voxel_bbox_extents)
    for fn in ("occupied_indices", "occupied_points", "occupied_values"):
        equal(getattr(got, fn)(), getattr(want, fn)())
    assert len(got.occupied_indices()) > 0


def _exact_pairwise(a, b):
    d = a[:, None, :] - b[None, :, :]
    return ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
            + d[..., 2] * d[..., 2])


@pytest.mark.parametrize("R,Q", [(50, 300), (500, 2000)])
def test_nn_matches_jax_exact_search(R, Q):
    rng = np.random.RandomState(R + Q)
    ref = (rng.normal(0, 0.05, (2, R, 3)) + [0, 0, 0.8]).astype(np.float32)
    query = (rng.normal(0, 0.05, (2, Q, 3)) + [0, 0, 0.8]).astype(np.float32)
    got = TG.nn(torch.from_numpy(ref), torch.from_numpy(query)).numpy()
    with mock.patch.object(jknn, "pairwise_sq_dist", _exact_pairwise):
        want = np.stack([np.asarray(JG.nn(jnp.asarray(r), jnp.asarray(q)))
                         for r, q in zip(ref, query)])
    assert jax.numpy.asarray(want).dtype == jnp.int32
    equal(got, want)
