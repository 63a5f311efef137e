"""Headless check: pseudo-occupancy grids of a CAD model -> OBJ meshes.

    python -m morefusion_tpu_torch.checks.check_occupancy_voxelization
        [--device cuda] [--out-dir DIR]

Port of ``checks/check_occupancy_voxelization.py``: class 2's solid voxel
points with their inside distances through ``pseudo_occupancy_voxelization``
at 32^3 (threshold 2.0) on ``--device``, where the min-distance kernel
(``csrc/min_dist.cu``) runs with the quantized SDF as its payload; the
uniform, surface and inside grids are written as OBJ meshes of their
voxels above 0.5. ``main`` returns the three grids, their voxel counts and
the meshes' vertex counts.
"""

from __future__ import annotations

import numpy as np

from . import _common

NAMES = ("uniform", "surface", "inside")


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    import torch

    from ..datasets import ProceduralModels
    from ..extra import viz
    from ..functions import pseudo_occupancy_voxelization

    models = ProceduralModels()
    class_id = 2
    vox = models.get_solid_voxel_grid(class_id)
    pitch = models.get_voxel_pitch(32, class_id)
    origin = -pitch * 15.5 * np.ones(3)

    device = torch.device(args.device)
    grids = pseudo_occupancy_voxelization(
        torch.as_tensor(np.asarray(vox.points, np.float32), device=device),
        torch.as_tensor(np.asarray(vox.inside_distance, np.float32),
                        device=device),
        pitch=pitch, origin=origin, dims=(32, 32, 32), threshold=2.0,
    )
    out = dict(grids={}, voxels={}, vertices={})
    for name, g in zip(NAMES, grids):
        g = g.cpu().numpy()
        verts, faces = viz.voxel_grid_to_mesh(g, pitch, origin, threshold=0.5)
        path = _common.out_path(args, f"occupancy_{name}.obj")
        viz.save_obj(path, verts, faces)
        out["grids"][name] = g
        out["voxels"][name] = int((g > 0.5).sum())
        out["vertices"][name] = int(len(verts))
        print(f"{name}: occ>{0.5} voxels={out['voxels'][name]} -> {path}")
    return out


if __name__ == "__main__":
    main()
