"""Headless data visualization of one synthetic frame.

    python -m morefusion_tpu_torch.cli.visualize_data [--frame 0]
        [--seed 0] [--out DIR] [--voxel-dim 32]

Port of ``examples/preliminary/visualize_data.py`` (reference
``examples/ycb_video/preliminary/visualize_pcds.py`` and
``visualize_grids.py``). Writes ``frame.png`` (the RGB, the depth
colormap, the instance labels and the ground-truth CAD pose overlay,
tiled 2 x 2) and ``grid_target.obj`` (the fused occupancy grid of the most
visible instance, as a box mesh) into ``--out``. Host only (the NumPy
occupancy mapping, the point-splat renderer); the PNG is written with
imageio or, where it is missing, cv2. ``main`` returns the paths written.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "mftpu_preliminary_viz"))
    parser.add_argument("--voxel-dim", type=int, default=32)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import geometry
    from ..contrib import MultiInstanceOccupancyMapping
    from ..datasets.rgbd_pose_estimation.synthetic import (
        SyntheticRGBDPoseEstimationDataset,
    )
    from ..extra import viz

    os.makedirs(args.out, exist_ok=True)
    ds = SyntheticRGBDPoseEstimationDataset(seed=args.seed)
    frame = ds.get_frame(args.frame)
    models = ds.models
    K = frame["intrinsic_matrix"]

    tiles = [
        frame["rgb"],
        viz.depth_to_rgb(frame["depth"]),
        viz.colorize_label(frame["instance_label"]),
        viz.draw_pose_overlay(
            frame["rgb"],
            models,
            list(frame["class_ids"]),
            list(frame["Ts_cad2cam"]),
            K,
        ),
    ]
    tiled = viz.tile_images(tiles, cols=2)
    png = os.path.join(args.out, "frame.png")
    viz.save_image(png, tiled)

    # the fused occupancy grid of the most visible instance -> OBJ mesh
    pcd = geometry.pointcloud_from_depth(
        frame["depth"], fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2]
    )
    areas = [
        (frame["instance_label"] == i).sum() for i in frame["instance_ids"]
    ]
    ti = int(np.argmax(areas))
    target_id = int(frame["instance_ids"][ti])
    class_id = int(frame["class_ids"][ti])
    pitch = models.get_voxel_pitch(args.voxel_dim, class_id)

    mapping = MultiInstanceOccupancyMapping()
    mapping.initialize(target_id, pitch=pitch)
    mask = frame["instance_label"] == target_id
    mapping.integrate(target_id, mask, pcd)

    nonnan = ~np.isnan(pcd).any(axis=2)
    center = np.nanmedian(pcd[mask & nonnan], axis=0)
    origin = center - pitch * (args.voxel_dim / 2.0 - 0.5)
    grid, _, _ = mapping.get_target_grids(
        target_id,
        dimensions=(args.voxel_dim,) * 3,
        pitch=pitch,
        origin=origin,
    )
    verts, faces = viz.voxel_grid_to_mesh(grid, pitch=pitch, origin=origin)
    obj = os.path.join(args.out, "grid_target.obj")
    viz.save_obj(obj, verts, faces)
    print(f"wrote {args.out}/frame.png and grid_target.obj "
          f"({len(verts)} verts)")
    return dict(png=png, obj=obj, n_vertices=len(verts))


if __name__ == "__main__":
    main()
