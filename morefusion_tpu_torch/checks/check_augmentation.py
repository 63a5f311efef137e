"""Headless check: host and device augmentation side by side -> PNG grid.

    python -m morefusion_tpu_torch.checks.check_augmentation
        [--device cuda] [--out-dir DIR]

Port of ``checks/check_augmentation.py``: one instance crop of a
``SyntheticRGBDPoseEstimationDataset`` frame under (row 1) the host
mask-truncation augmentation (``augment_mask``, ``RandomState(0)``) and
(row 2) the device photometric augmentation
(``training.augment_device.augment_rgb_device``) on ``--device``. JAX's
``jax.random.PRNGKey(s)``, ``s = 1..3``, becomes a torch generator of the
device seeded ``s``: the draws differ from JAX's by design, the
augmentation at the same parameters does not. ``main`` returns both rows
(row 2 as the float32 images before the cast to uint8) and the grid.
"""

from __future__ import annotations

import numpy as np

from . import _common


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    import torch

    from .. import datasets
    from ..datasets.rgbd_pose_estimation.augmentation import augment_mask
    from ..extra import viz
    from ..training import augment_device

    src = datasets.SyntheticRGBDPoseEstimationDataset(
        split="train", n_frames=1, n_objects=(3, 4)
    )
    ex = src.get_example(0)[0]
    rgb, pcd = ex["rgb"], ex["pcd"]

    host_rng = np.random.RandomState(0)
    row1 = [rgb] + [
        augment_mask(rgb, pcd, host_rng)[0] for _ in range(3)
    ]

    device = torch.device(args.device)
    x = torch.from_numpy(rgb[None].astype(np.float32)).to(device)
    row2_float = []
    for s in range(1, 4):
        gen = torch.Generator(device=device).manual_seed(s)
        row2_float.append(
            augment_device.augment_rgb_device(gen, x)[0].cpu().numpy())
    row2 = [rgb] + [a.astype(np.uint8) for a in row2_float]

    image = viz.tile_images(row1 + row2, cols=4)
    out = _common.out_path(args, "augmentation.png")
    viz.save_image(out, image)
    print("wrote", out)
    return dict(row1=row1, row2_float=row2_float, image=image)


if __name__ == "__main__":
    main()
