"""Headless check: fuse a synthetic frame into the C++ mapping and render
the predicted instance labels back -> PNG.

    python -m morefusion_tpu_torch.checks.check_mapping_render
        [--out-dir DIR]

Port of ``checks/check_mapping_render.py`` (the OctomapServer render
role): one 240x320 frame of a seed-1 scene of 3 objects, its world-frame
cloud fused by ``OccupancyFusion(size_filter=False).process_frame`` on the
port's C++ mapping (``csrc/mapping.cpp``, built with g++ on first use),
then ``render_labels`` from the same camera. Prints the label agreement on
the object pixels; writes the true and rendered labels side by side. Host
only (``--device`` is accepted and unused). ``main`` returns the agreement,
the rendered labels and the image.
"""

from __future__ import annotations

import numpy as np

from . import _common


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    from ..datasets import ProceduralModels
    from ..extra import viz
    from ..geometry import pointcloud_from_depth
    from ..geometry.transform import transform_points_np
    from ..runtime.fusion import OccupancyFusion
    from ..simulation import PlaneTypeSceneGeneration

    models = ProceduralModels()
    gen = PlaneTypeSceneGeneration(
        models, n_object=3, random_state=np.random.RandomState(1)
    )
    gen.generate()
    T_cam = gen.random_camera_trajectory(4, 3)[0]
    frame = gen.render_frame(T_cam, shape=(240, 320))
    K = frame["intrinsic_matrix"]
    depth = frame["depth"]
    H, W = depth.shape
    pcd = pointcloud_from_depth(depth, K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    flat = pcd.reshape(-1, 3)
    ok = ~np.isnan(flat).any(axis=1)
    pw = np.full_like(flat, np.nan)
    pw[ok] = transform_points_np(flat[ok], frame["T_cam2world"])
    pw = pw.reshape(H, W, 3)

    fusion = OccupancyFusion(models, size_filter=False)
    inst_to_class = {
        int(i): int(c)
        for i, c in zip(frame["instance_ids"], frame["class_ids"])
    }
    fusion.process_frame(
        pw, frame["instance_label"], inst_to_class, track=False,
        camera_origin=frame["T_cam2world"][:3, 3],
    )
    label, _ = fusion.render_labels(K, frame["T_cam2world"], (H, W))
    agree = (
        (label == frame["instance_label"])[frame["instance_label"] >= 0]
    ).mean()
    print(f"raycast label agreement on object pixels: {agree:.3f}")
    image = viz.tile_images(
        [
            viz.colorize_label(frame["instance_label"]),
            viz.colorize_label(label),
        ]
    )
    out = _common.out_path(args, "mapping_render.png")
    viz.save_image(out, image)
    print("wrote", out)
    return dict(agreement=float(agree), label=label, image=image)


if __name__ == "__main__":
    main()
