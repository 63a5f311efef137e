"""The port's ``extra.meshio`` against ``morefusion_tpu.extra.meshio``.

Both are float64 NumPy on the host, so every output must be equal bit for
bit: parsed OBJ and XYZ files (a fan-triangulated quad with texture and
normal indices), face areas, surface samples, the z-ray crossings, the
solid grids with their pitch and origin, the EDT inside distances, and the
box, bin and tiled meshes. The meshes voxelized: a box, a bin, the tiled
meshes, the quad OBJ and ``voxel_grid_to_mesh`` of procedural models'
solid grids (whose faces are split along diagonals a ray can hit).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from morefusion_tpu.extra import meshio as JM
from morefusion_tpu_torch import extra as TX
from morefusion_tpu_torch.datasets import ProceduralModels
from morefusion_tpu_torch.extra import meshio as TM
from morefusion_tpu_torch.extra import viz as TV

torch.set_num_threads(2)

QUAD_OBJ = """# a cube of quads, with texture and normal indices
v -0.05 -0.04 -0.03
v 0.05 -0.04 -0.03
v 0.05 0.04 -0.03
v -0.05 0.04 -0.03
v -0.05 -0.04 0.03
v 0.05 -0.04 0.03
v 0.05 0.04 0.03
v -0.05 0.04 0.03
vt 0 0
vn 0 0 1
f 1/1/1 4/1/1 3/1/1 2/1/1
f 5/1/1 6/1/1 7/1/1 8/1/1
f 1/1/1 2/1/1 6/1/1 5/1/1
f 2/1/1 3/1/1 7/1/1 6/1/1
f 3/1/1 4/1/1 8/1/1 7/1/1
f 4//1 1//1 5//1 8//1
"""


def equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def procedural_mesh(class_id):
    """``voxel_grid_to_mesh`` of a procedural model's solid grid, each
    voxel's box centred on its point."""
    grid = ProceduralModels().get_solid_voxel_grid(class_id)
    idx = np.round((grid.points - grid.origin) / grid.pitch).astype(int)
    occ = np.zeros(idx.max(axis=0) + 1, bool)
    occ[tuple(idx.T)] = True
    return TV.voxel_grid_to_mesh(occ, grid.pitch,
                                 np.asarray(grid.origin) - grid.pitch / 2)


def quad_mesh(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text(QUAD_OBJ)
    return TM.load_obj(str(path))


MESHES = {
    "box": lambda tmp: TM.box_mesh((0.1, 0.06, 0.04), (0.01, -0.02, 0.5)),
    "bin": lambda tmp: TM.bin_model((0.3, 0.2, 0.1), 0.02),
    "tiled": lambda tmp: TM.tile_meshes(
        [TM.box_mesh((0.05, 0.05, 0.05)), TM.bin_model((0.1, 0.08, 0.05),
                                                       0.01),
         TM.box_mesh((0.02, 0.08, 0.03))]),
    "quad_obj": quad_mesh,
    "procedural_mug": lambda tmp: procedural_mesh(14),
    "procedural_drill": lambda tmp: procedural_mesh(15),
}


def test_exported_from_extra():
    assert TX.meshio is TM


def test_load_obj_fan_triangulates(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text(QUAD_OBJ)
    got, want = TM.load_obj(str(path)), JM.load_obj(str(path))
    for g, w in zip(got, want):
        equal(g, w)
    assert got[1].shape == (12, 3)


def test_load_xyz(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "points.xyz"
    np.savetxt(path, np.c_[rng.normal(size=(50, 3)), rng.rand(50, 3)])
    equal(TM.load_xyz(str(path)), JM.load_xyz(str(path)))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_face_areas_and_samples(name, tmp_path):
    v, f = MESHES[name](tmp_path)
    equal(TM.face_areas(v, f), JM.face_areas(v, f))
    equal(TM.sample_surface(v, f, 300),
          JM.sample_surface(v, f, 300))
    equal(TM.sample_surface(v, f, 100, np.random.RandomState(5)),
          JM.sample_surface(v, f, 100, np.random.RandomState(5)))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ray_crossings(name, tmp_path):
    v, f = MESHES[name](tmp_path)
    rng = np.random.RandomState(1)
    lo, hi = v.min(axis=0), v.max(axis=0)
    xy = rng.uniform(lo[:2], hi[:2], (64, 2))
    got = TM._ray_triangle_hits_z(v, f, xy)
    want = JM._ray_triangle_hits_z(v, f, xy)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        equal(g, w)


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("block", [1, 7 * 12, 1 << 22])
def test_ray_crossings_in_blocks(name, block, tmp_path):
    """The port tests a block of rays at once: a ray a block, blocks that
    leave a remainder, and all rays in one block give JAX's per-ray
    crossings bit for bit, also for rays through vertices and edges (a
    grid over the bounding box, its corners included)."""
    v, f = MESHES[name](tmp_path)
    lo, hi = v.min(axis=0), v.max(axis=0)
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], 9),
                         np.linspace(lo[1], hi[1], 7), indexing="ij")
    xy = np.stack([gx.ravel(), gy.ravel()], axis=1)
    with mock.patch.object(TM, "RAY_BLOCK_ELEMENTS", block * len(f)):
        got = TM._ray_triangle_hits_z(v, f, xy)
    want = JM._ray_triangle_hits_z(v, f, xy)
    assert len(got) == len(want) == len(xy)
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        equal(g, w)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_solid_voxelize_and_inside_distance(name, tmp_path):
    v, f = MESHES[name](tmp_path)
    dim = 24
    occ, pitch, origin = TM.solid_voxelize(v, f, dim)
    occ_j, pitch_j, origin_j = JM.solid_voxelize(v, f, dim)
    equal(occ, occ_j)
    assert type(pitch) is type(pitch_j) and pitch == pitch_j
    equal(origin, origin_j)
    assert occ.any()
    equal(TM.inside_distance_from_occupancy(occ, pitch),
          JM.inside_distance_from_occupancy(occ_j, pitch_j))


def test_box_merge_bin_tile():
    for args in (((0.1, 0.2, 0.3),), ((1, 2, 3), (0.5, -0.5, 2.0))):
        for g, w in zip(TM.box_mesh(*args), JM.box_mesh(*args)):
            equal(g, w)
    meshes = [TM.box_mesh((0.1, 0.1, 0.1)), TM.bin_model((0.3, 0.2, 0.1),
                                                         0.01)]
    for g, w in zip(TM.merge_meshes(meshes), JM.merge_meshes(meshes)):
        equal(g, w)
    for g, w in zip(TM.bin_model((0.4, 0.3, 0.2), 0.015),
                    JM.bin_model((0.4, 0.3, 0.2), 0.015)):
        equal(g, w)
    five = [TM.box_mesh((0.05 * (k + 1),) * 3) for k in range(5)]
    for kw in ({}, dict(shape=(1, 5)), dict(spacing=0.5),
               dict(shape=(3, 2), spacing=0.2)):
        for g, w in zip(TM.tile_meshes(five, **kw),
                        JM.tile_meshes(five, **kw)):
            equal(g, w)
