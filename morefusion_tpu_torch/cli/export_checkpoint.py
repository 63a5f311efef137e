"""Archive a trained run's best weights as a git-committable bf16 npz.

    python -m morefusion_tpu_torch.cli.export_checkpoint --log-dir RUN
        --out docs/results/NAME_best_bf16.npz
        [--metric validation/main/auc] [--device cuda]

Port of ``examples/export_checkpoint.py``, plus ``--device`` (default
``cuda``: where the model is built and the snapshot restored). The run is
a ``cli.train`` directory (its ``args.json`` rebuilds the model, tiny
when it was trained tiny) with a ``snapshot_model_best_<metric>``, or its
archive alone; the archive is written by ``training.export_params_npz``,
the writer of ``CheckpointManager.save_best``, so it equals the run's own
``<snapshot>.npz`` entry for entry. ``main`` returns the output path.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log-dir", required=True)
    parser.add_argument("--metric", default="validation/main/auc")
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the restored model")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from .. import training
    from ._eval import build_model

    model = build_model(training.load_args(args.log_dir),
                        torch.device(args.device))
    restored = training.CheckpointManager(args.log_dir).restore_best(
        model, args.metric)
    if restored is None:
        raise SystemExit(f"no best-{args.metric} snapshot in {args.log_dir}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    training.export_params_npz(restored, args.out)
    mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({mb:.1f} MB)")
    return args.out


if __name__ == "__main__":
    main()
