"""Per-class voxel-size table.

    python -m morefusion_tpu_torch.cli.compute_voxel_size [--voxel-dim 32]
        [--out CSV] [--ycb-video]

Port of ``examples/preliminary/compute_voxel_size.py`` (reference
``examples/ycb_video/preliminary/compute_voxel_size.py``). For every
foreground class: the CAD bbox diagonal and the voxel pitch
``diagonal / voxel_dim`` (``ModelsBase.get_voxel_pitch``), printed and,
with ``--out``, written as CSV. The procedural bank by default;
``--ycb-video`` reads ``YCBVideoModels`` from
``$MOREFUSION_TPU_DATA/ycb_video/YCB_Video_Models``. Host only. ``main``
returns the rows.
"""

from __future__ import annotations

import argparse
import csv
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--voxel-dim", type=int, default=32, help="grid resolution"
    )
    parser.add_argument("--out", default=None, help="optional CSV path")
    parser.add_argument(
        "--ycb-video",
        action="store_true",
        help="use the YCB-Video CAD bank (requires data on disk) instead "
        "of the zero-asset procedural models",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.ycb_video:
        from ..datasets import YCBVideoModels

        models = YCBVideoModels()
    else:
        from ..datasets import ProceduralModels

        models = ProceduralModels()

    rows = []
    for class_id in range(1, models.n_class):
        diagonal = models.get_bbox_diagonal(class_id)
        rows.append(
            dict(
                class_id=class_id,
                name=models.class_names[class_id],
                bbox_diagonal=round(float(diagonal), 6),
                voxel_size=round(float(diagonal) / args.voxel_dim, 6),
            )
        )

    w = max(len(r["name"]) for r in rows)
    print(f"{'id':>3} {'name':<{w}} {'bbox_diagonal':>14} {'voxel_size':>11}")
    for r in rows:
        print(
            f"{r['class_id']:>3} {r['name']:<{w}} "
            f"{r['bbox_diagonal']:>14.6f} {r['voxel_size']:>11.6f}"
        )

    if args.out:
        with open(args.out, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
