"""End-to-end demo: synthetic scene -> full pipeline -> visualization PNG.

    python -m morefusion_tpu_torch.cli.demo [--out PNG] [--log-dir RUN]
        [--seed 3] [--n-objects 3] [--image-shape 240 320] [--tiny]
        [--refine] [--device cuda]

Port of ``examples/demo.py``, plus ``--device`` (default ``cuda``).
Equivalent of the reference's interactive demo
(``examples/ycb_video/singleview_3d/demo.py``) rendered offscreen: the
output image tiles [input rgb | GT segmentation | predicted-pose overlay].
Works with an untrained model (seeded weights) or the best snapshot of a
``--log-dir`` run (``cli/train.py``'s, or its best archive alone). With
``--refine`` the frame's spawned objects go through ICC; one frame spawns
none at the pipeline's 3 votes, as in JAX's demo. ``main`` returns the
frame's poses.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "mftpu_demo.png"))
    parser.add_argument("--log-dir", default=None, help="trained checkpoint")
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--n-objects", type=int, default=3)
    parser.add_argument("--image-shape", type=int, nargs=2, default=(240, 320))
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--refine", action="store_true", help="run ICC")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and ICC")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from .. import models, runtime, training
    from ..datasets import ProceduralModels
    from ..extra import viz
    from ..simulation import PlaneTypeSceneGeneration

    device = torch.device(args.device)
    models_bank = ProceduralModels()
    gen = PlaneTypeSceneGeneration(
        models_bank,
        n_object=args.n_objects,
        random_state=np.random.RandomState(args.seed),
    )
    gen.generate()
    T_cam = gen.random_camera_trajectory(4, 3, distance=(0.45, 0.6))[0]
    frame = gen.render_frame(T_cam, shape=tuple(args.image_shape))

    make = models.tiny_singleview3d if args.tiny else (
        lambda n, **kw: models.SingleView3D(n_fg_class=n, **kw)
    )
    torch.manual_seed(0)
    model = make(21, with_occupancy=True).to(device)
    if args.log_dir:
        # no best snapshot: the seeded weights stay, as JAX keeps its init
        training.CheckpointManager(args.log_dir).restore_best(
            model, "validation/main/auc")

    pipe = runtime.ScenePipeline(
        model, models_bank, size_filter=False, device=device
    )
    inst_to_class = {
        int(i): int(frame["class_ids"][k])
        for k, i in enumerate(frame["instance_ids"])
    }
    results = pipe.process_frame(
        frame["rgb"].astype(np.float32),
        frame["depth"],
        frame["intrinsic_matrix"],
        frame["T_cam2world"],
        instance_label=frame["instance_label"],
        instance_to_class=inst_to_class,
        refine=args.refine,
    )
    print(f"estimated {len(results)} poses")

    seg_view = viz.draw_instance_segmentation(
        frame["rgb"], frame["instance_label"]
    )
    class_ids = [r["class_id"] for r in results.values()]
    Ts = [r["T_cad2cam"] for r in results.values()]
    overlay = viz.draw_pose_overlay(
        frame["rgb"], models_bank, class_ids, Ts, frame["intrinsic_matrix"]
    )
    panel = viz.tile_images([frame["rgb"], seg_view, overlay])
    viz.save_image(args.out, panel)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
