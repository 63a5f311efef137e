"""Train the volumetric pose model (the SingleView3D recipe) with the port.

    python -m morefusion_tpu_torch.cli.train --out RUN_DIR [--data DIR ...]
    torchrun --nproc_per_node N -m morefusion_tpu_torch.cli.train ...

The flags of ``examples/train.py`` (Adam 1e-4, batch 16, 30 epochs,
``add -> add/add_s`` after epoch 1, evaluation every 0.25 epoch, snapshots
latest / best ADD / best AUC), plus ``--device`` (default ``cuda``),
``--log-interval`` and ``--val-batch-size``. Under ``torchrun`` the run is
data parallel over its processes, one card each (``--batch-size`` is the
global batch). ``--data`` takes packed or reindexed directories (several
are concatenated); a packed set does the photometric and point-cloud
augmentation on the device, a reindexed one on the host, and a packed set
ships its batches in the single-buffer transfer form (its transfer arrays
are derived first where missing), as does a packed val set.
Without ``--data`` a small synthetic set (16 / 4 frames) is generated
under ``--out``. ``--model posenet`` trains the point-cloud baseline
(``models.PoseNet`` at full width; ``--tiny`` and ``--bf16`` apply to
SingleView3D only, as in JAX).

On the leak-budget exit (``--rss-exit-gb``: the latest checkpoint saved,
exit code 42, for a relaunch with ``--resume``) the run also leaves an
empty ``leak_budget_exit`` file in ``--out``: ``torchrun`` reports a
worker's exit code 42 as 1, and the campaign scripts read the file instead.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

#: the file the leak-budget exit leaves in the run directory
LEAK_EXIT_FILE = "leak_budget_exit"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument(
        "--data", default=None, nargs="+",
        help="reindexed/packed dataset dir(s); several dirs are "
        "concatenated",
    )
    parser.add_argument(
        "--balance-sources", action="store_true",
        help="subsample every extra --data source down to the first "
        "source's size",
    )
    parser.add_argument("--val-data", default=None)
    parser.add_argument(
        "--model", default="singleview_3d",
        choices=["singleview_3d", "posenet"],
    )
    parser.add_argument("--with-occupancy", action="store_true")
    parser.add_argument(
        "--loss", default="add/add_s",
        choices=["add", "add/add_s", "add+occupancy", "add/add_s+occupancy"],
    )
    parser.add_argument(
        "--min-visibility", type=float, default=0.8,
        help="drop train crops below this visibility (val keeps every "
        "instance); 0.0 keeps all",
    )
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument(
        "--lr-schedule", default="constant", choices=["constant", "cosine"],
        help="cosine: warmup + cosine decay to 5%% of --lr over the run",
    )
    parser.add_argument("--warmup-steps", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument(
        "--pretrained-model", default=None,
        help="weights-only init from an exported npz checkpoint (either "
        "package's); the optimizer starts fresh",
    )
    parser.add_argument(
        "--pretrained-backbone", default=None,
        help="graft a backbone npz (keys ['resnet_extractor'][...]) under "
        "the fresh init",
    )
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument(
        "--num-workers", type=int, default=0,
        help="data-loading worker processes (0 = one prefetch thread)",
    )
    parser.add_argument(
        "--bf16", action="store_true",
        help="bf16 compute for the conv / dense stacks (weights, optimizer "
        "state, poses and losses stay fp32)",
    )
    parser.add_argument("--tiny", action="store_true", help="CI-sized model")
    parser.add_argument("--n-point", type=int, default=1000)
    parser.add_argument("--eval-interval", type=float, default=0.25,
                        help="epochs between evaluations")
    parser.add_argument("--log-interval", type=int, default=20,
                        help="steps between log rows")
    parser.add_argument("--val-batch-size", type=int, default=48,
                        help="evaluation batch; the last partial batch "
                        "is dropped")
    parser.add_argument(
        "--rss-exit-gb", type=float, default=0.0,
        help="exit cleanly (code 42, checkpoint saved) when the host's "
        "resident memory exceeds this; relaunch with --resume",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and the steps")
    return parser.parse_args(argv)


def build_datasets(args):
    """(train, val, device_augment) from the arguments."""
    from .. import datasets, parallel

    if not args.data:
        print("no --data: generating a small synthetic set inline")
        train_dir = os.path.join(args.out, "data_train")
        val_dir = os.path.join(args.out, "data_val")
        for split, path, n in (("train", train_dir, 16), ("val", val_dir, 4)):
            if (parallel.is_primary()  # the other ranks wait below
                    and not os.path.exists(os.path.join(path, "meta.json"))):
                src = datasets.SyntheticRGBDPoseEstimationDataset(
                    split=split, n_frames=n, n_objects=(2, 4))
                datasets.reindex(path, [src], n_workers=1)
        parallel.barrier()
        train = datasets.RGBDPoseEstimationDatasetReIndexed(
            train_dir, split="train", augmentation=True)
        val = datasets.RGBDPoseEstimationDatasetReIndexed(
            val_dir, split="val")
        return train, val, False

    def build_train(path):
        if datasets.is_packed(path):
            # the host does the mask truncation only; the photometric and
            # point-cloud augmentation runs in the step, and the batch
            # ships as one packed buffer (training/transfer.py)
            if not datasets.has_transfer_arrays(path):
                datasets.derive_transfer_arrays(path)
            return datasets.PackedPoseDataset(
                path, split="train", augmentation=True, transfer=True,
                min_visibility=args.min_visibility)
        return datasets.RGBDPoseEstimationDatasetReIndexed(
            path, split="train", augmentation=True,
            min_visibility=args.min_visibility)

    sources = [build_train(p) for p in args.data]
    device_augment = all(
        isinstance(s, datasets.PackedPoseDataset) for s in sources)
    if args.balance_sources and len(sources) > 1:
        n0 = len(sources[0])
        sources[1:] = [datasets.RandomSamplingDataset(s, n0, seed=args.seed)
                       for s in sources[1:]]
    train = (sources[0] if len(sources) == 1
             else datasets.ConcatDataset(*sources))
    print("train sources:", [len(s) for s in sources])
    val_path = args.val_data or args.data[0]
    if datasets.is_packed(val_path):
        if not datasets.has_transfer_arrays(val_path):
            datasets.derive_transfer_arrays(val_path)
        val = datasets.PackedPoseDataset(val_path, split="val",
                                         transfer=True)
    else:
        val = datasets.RGBDPoseEstimationDatasetReIndexed(val_path,
                                                          split="val")
    return train, val, device_augment


def learning_rate(args, n_train: int):
    """``--lr``, or the warmup-cosine schedule of ``--lr-schedule cosine``
    (warmup ``min(--warmup-steps, total // 10)``, down to 5% of ``--lr``
    at the run's last step)."""
    if args.lr_schedule != "cosine":
        return args.lr
    from ..training.trainer import warmup_cosine_decay_schedule

    steps_per_epoch = max(1, n_train // args.batch_size)
    total_steps = args.max_steps or steps_per_epoch * args.epochs
    print(f"cosine lr schedule: peak {args.lr}, {total_steps} decay steps")
    return warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=args.lr,
        warmup_steps=min(args.warmup_steps, max(1, total_steps // 10)),
        decay_steps=total_steps,
        end_value=args.lr * 0.05,
    )


def main(argv=None):
    """Run the training; returns (state, the last evaluation's summary)."""
    args = parse_args(argv)
    from .. import models, parallel
    from ..datasets import ProceduralModels, Transform
    from ..training import loop

    # a no-op outside torchrun
    parallel.maybe_initialize(device=args.device)
    n_fg_class = 21
    with_occupancy = args.with_occupancy or "occupancy" in args.loss
    train_ds, val_ds, device_augment = build_datasets(args)

    torch.manual_seed(args.seed)
    if args.model == "posenet":  # --tiny and --bf16 are SingleView3D's
        model = models.PoseNet(n_fg_class=n_fg_class, n_point=args.n_point)
    elif args.tiny:
        model = models.tiny_singleview3d(
            n_fg_class, n_point=args.n_point, with_occupancy=with_occupancy)
    else:
        model = models.SingleView3D(
            n_fg_class=n_fg_class, n_point=args.n_point,
            with_occupancy=with_occupancy,
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)

    try:
        state, summary = loop.fit(
            model=model,
            models_bank=ProceduralModels(),
            train_dataset=train_ds,
            val_dataset=val_ds,
            out_dir=args.out,
            transform_train=Transform(train=True,
                                      with_occupancy=with_occupancy),
            transform_val=Transform(train=False,
                                    with_occupancy=with_occupancy),
            n_fg_class=n_fg_class,
            batch_size=args.batch_size,
            epochs=args.epochs,
            learning_rate=learning_rate(args, len(train_ds)),
            loss=args.loss,
            eval_interval=args.eval_interval,
            log_interval=args.log_interval,
            seed=args.seed,
            resume=args.resume,
            pretrained_model=args.pretrained_model,
            pretrained_backbone=args.pretrained_backbone,
            max_steps=args.max_steps,
            args_dict=vars(args),
            num_workers=args.num_workers,
            device_augment=device_augment,
            val_batch_size=args.val_batch_size,
            rss_exit_gb=args.rss_exit_gb,
            device=args.device,
        )
    except loop.LeakBudgetExit as e:
        print(f"leak-budget exit: {e}")
        open(os.path.join(args.out, LEAK_EXIT_FILE), "w").close()
        raise SystemExit(42)
    print("final summary:", {k: round(v, 4) for k, v in summary.items()
                             if k.count("/") <= 2})
    return state, summary


if __name__ == "__main__":
    main(sys.argv[1:])
