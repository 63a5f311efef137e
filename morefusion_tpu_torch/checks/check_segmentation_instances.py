"""Headless check: boundary-based multi-instance recovery -> PNG.

    python -m morefusion_tpu_torch.checks.check_segmentation_instances
        [--device cuda] [--out-dir DIR]

Port of ``checks/check_segmentation_instances.py``: a cluttered frame of
``SyntheticInstanceSegmentationDataset`` (seed 11, 8 objects), its
ground-truth instance, class and boundary maps, and the instances that
``instances_from_predictions`` recovers from the *ground-truth* class map
and boundary, which isolates the instancing from a model's quality.
Prints the (matched, ground-truth, recovered) counts; writes the RGB, both
labelings and the boundary. Beside that host instancing (cv2, as in JAX)
it runs the segmentation node's device instancing on ``--device``
(``ops.connected_components`` then ``relabel_components``) on the same maps
and prints its counts too. ``main`` returns both labelings, both counts
and the image.
"""

from __future__ import annotations

import numpy as np

from . import _common


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    import torch

    from ..datasets.instance_segmentation import (
        SyntheticInstanceSegmentationDataset,
    )
    from ..extra import viz
    from ..models.segmentation import (
        instances_from_predictions,
        match_instances,
    )
    from ..ops import connected_components, relabel_components

    ds = SyntheticInstanceSegmentationDataset(
        split="train", n_frames=1, n_objects=(8, 8), format="instance",
        seed=11,
    )
    ex = ds.get_example(0)
    lab, cm, bnd = ex["instance_label"], ex["class_label"], ex["boundary"]

    pred_label, pred_classes = instances_from_predictions(cm, bnd)
    gt_classes = {}
    for gid in np.unique(lab):
        if gid < 0:
            continue
        gt_classes[int(gid)] = int(cm[lab == gid][0])
    m, g, p = match_instances(pred_label, pred_classes, lab, gt_classes)
    print(
        f"instances: gt={g} recovered={p} matched(IoU>=0.5)={m}; "
        f"boundary pixels={int(bnd.sum())}"
    )

    device = torch.device(args.device)
    comp = connected_components(
        torch.from_numpy(np.asarray(cm, np.int32)).to(device),
        torch.from_numpy(np.asarray(bnd, bool)).to(device),
    )
    dev_label, dev_classes = relabel_components(comp.cpu().numpy(), cm)
    dm, dg, dp = match_instances(dev_label, dev_classes, lab, gt_classes)
    print(f"device instancing ({device.type}): gt={dg} recovered={dp} "
          f"matched(IoU>=0.5)={dm}")

    rgb = ex["rgb"].astype(np.uint8)
    tiles = [
        rgb,
        viz.draw_instance_segmentation(rgb, lab, alpha=0.6),
        viz.draw_instance_segmentation(rgb, pred_label, alpha=0.6),
        np.stack([bnd.astype(np.uint8) * 255] * 3, axis=-1),
    ]
    image = viz.tile_images(tiles, cols=2)
    out = _common.out_path(args, "segmentation_instances.png")
    viz.save_image(out, image)
    print("wrote", out)
    return dict(counts=(m, g, p), label=pred_label, classes=pred_classes,
                device_counts=(dm, dg, dp), device_label=dev_label,
                device_classes=dev_classes,
                boundary_pixels=int(bnd.sum()), image=image)


if __name__ == "__main__":
    main()
