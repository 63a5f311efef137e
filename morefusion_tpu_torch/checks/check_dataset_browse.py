"""Headless check: browse pose-estimation training examples -> PNG tiles.

    python -m morefusion_tpu_torch.checks.check_dataset_browse
        [--data DIR] [--n 8] [--out-dir DIR]

Port of ``checks/check_dataset_browse.py``: a reindexed or packed set
(``--data``), or else two frames of ``SyntheticRGBDPoseEstimationDataset``
reindexed with one worker into ``OUT_DIR/browse_data`` (kept for the next
run). Each tile shows an instance's RGB crop, its depth coloured and its
occupancy grid's sum along z; prints each example's class and voxel pitch.
Host only (``--device`` is accepted and unused). ``main`` returns the
classes, the pitches and the tiled image.
"""

from __future__ import annotations

import os

import numpy as np

from . import _common


def main(argv=None):
    parser = _common.parser(__doc__)
    parser.add_argument("--data", default=None, help="reindexed/packed dir")
    parser.add_argument("--n", type=int, default=8)
    args = parser.parse_args(argv)
    import cv2

    from .. import datasets
    from ..extra import viz

    if args.data and datasets.is_packed(args.data):
        ds = datasets.PackedPoseDataset(args.data)
    elif args.data:
        ds = datasets.RGBDPoseEstimationDatasetReIndexed(args.data)
    else:
        src = datasets.SyntheticRGBDPoseEstimationDataset(
            split="train", n_frames=2, n_objects=(3, 5)
        )
        root = os.path.join(args.out_dir, "browse_data")
        if not os.path.exists(os.path.join(root, "meta.json")):
            datasets.reindex(root, [src], n_workers=1, progress=False)
        ds = datasets.RGBDPoseEstimationDatasetReIndexed(root)

    tiles, class_ids, pitches = [], [], []
    for i in range(min(args.n, len(ds))):
        ex = ds.get_example(i)
        rgb = np.asarray(ex["rgb"], np.uint8)
        depth = np.asarray(ex["pcd"])[..., 2]
        d_rgb = viz.depth_to_rgb(depth)
        grid = np.asarray(ex["grid_target"], np.float32)
        g_img = (grid.sum(axis=2) > 0).astype(np.uint8) * 255
        g_rgb = np.stack([g_img] * 3, axis=-1)
        g_rgb = cv2.resize(
            g_rgb, rgb.shape[:2][::-1], interpolation=cv2.INTER_NEAREST
        )
        tiles.append(np.concatenate([rgb, d_rgb, g_rgb], axis=1))
        class_ids.append(int(ex["class_id"]))
        pitches.append(float(ex["pitch"]))
        print(
            f"example {i}: class={class_ids[-1]} pitch={pitches[-1]:.4f}"
        )

    image = viz.tile_images(tiles, cols=2)
    out = _common.out_path(args, "dataset_browse.png")
    viz.save_image(out, image)
    print("wrote", out)
    return dict(class_ids=class_ids, pitches=pitches, image=image)


if __name__ == "__main__":
    main()
