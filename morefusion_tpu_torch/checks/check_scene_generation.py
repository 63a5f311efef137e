"""Headless check: cluttered-scene generation from 3 viewpoints -> PNG.

    python -m morefusion_tpu_torch.checks.check_scene_generation
        [--out-dir DIR]

Port of ``checks/check_scene_generation.py``: ``PlaneTypeSceneGeneration``
(seed 7, 5 objects) rendered from 3 trajectory views at 240x320, each with
its instance segmentation drawn over it, tiled into ``scene_views.png``.
Host only (``--device`` is accepted and unused). ``main`` returns the
number of placed objects and the tiled image.
"""

from __future__ import annotations

import numpy as np

from . import _common


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    from ..datasets import ProceduralModels
    from ..extra import viz
    from ..simulation import PlaneTypeSceneGeneration

    models = ProceduralModels()
    gen = PlaneTypeSceneGeneration(
        models, n_object=5, random_state=np.random.RandomState(7)
    )
    gen.generate()
    print(f"placed {len(gen.objects)} objects")
    traj = gen.random_camera_trajectory(6, 3)
    views = []
    for T in traj:
        frame = gen.render_frame(T, shape=(240, 320))
        views.append(
            viz.draw_instance_segmentation(
                frame["rgb"], frame["instance_label"], alpha=0.3
            )
        )
    image = viz.tile_images(views)
    out = _common.out_path(args, "scene_views.png")
    viz.save_image(out, image)
    print("wrote", out)
    return dict(n_objects=len(gen.objects), image=image)


if __name__ == "__main__":
    main()
