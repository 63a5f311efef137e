"""Generate a synthetic reindexed training set (no external data needed).

    python -m morefusion_tpu_torch.cli.generate_data --out DIR \\
        [--split train|val] [--n-frames 200] [--n-workers 4] [--textured]

The flags of ``examples/synthetic/generate_data.py``: cluttered scenes of
the procedural model bank, rendered frames, then one npz per instance and
a ``meta.json`` (``datasets.reindex``). It runs on the host only (NumPy and
the C++ mapping, in forked workers with ``--n-workers``); pack the result
with ``datasets.pack_reindexed`` for ``cli.train``.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="output root dir")
    parser.add_argument("--split", default="train", choices=["train", "val"])
    parser.add_argument("--n-frames", type=int, default=200)
    parser.add_argument("--n-objects", type=int, nargs=2, default=(3, 6))
    parser.add_argument("--image-shape", type=int, nargs=2,
                        default=(240, 320))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-workers", type=int, default=1)
    parser.add_argument(
        "--settle", default="physics", choices=["physics", "drop"],
        help="physics: quasi-static settled resting poses; drop: the plane "
        "drop of the earlier validation set",
    )
    parser.add_argument(
        "--textured", action="store_true",
        help="procedurally textured model bank (checker + label patch in "
        "canonical coordinates); the scene of a seed is the untextured "
        "one's",
    )
    return parser.parse_args(argv)


def main(argv=None):
    """Write the set; returns its ``meta`` dict."""
    args = parse_args(argv)
    from .. import datasets

    ds = datasets.SyntheticRGBDPoseEstimationDataset(
        split=args.split,
        models=datasets.ProceduralModels(textured=True)
        if args.textured else None,
        n_frames=args.n_frames,
        n_objects=tuple(args.n_objects),
        seed=args.seed,
        image_shape=tuple(args.image_shape),
        settle=args.settle,
    )
    meta = datasets.reindex(args.out, [ds], n_workers=args.n_workers)
    print(f"wrote {len(meta)} instance examples to {args.out}")
    return meta


if __name__ == "__main__":
    main(sys.argv[1:])
