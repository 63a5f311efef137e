"""Train the instance-segmentation UNet (class + instance-boundary heads).

    python -m morefusion_tpu_torch.cli.train_segmentation --out DIR \\
        [--n-frames 800] [--steps 4000] [--use-depth] [--device cuda]
    torchrun --nproc_per_node N -m morefusion_tpu_torch.cli.train_segmentation ...

The flags of ``examples/train_segmentation.py``, plus ``--device`` (default
``cuda``). A UNet predicts per-pixel class logits and, unless
``--no-boundary``, an instance-boundary logit; the loss is the class
cross-entropy (``--fg-weight`` on foreground pixels) plus the boundary's
weighted BCE, under Adam at ``--lr``. Frames come from the procedural
generator with composited backgrounds
(``SyntheticInstanceSegmentationDataset``; set ``MFTPU_SEG_CACHE`` to a
directory to share them across processes), with the photometric
augmentation unless ``--no-augment``. Batches ship
quantised (uint8 rgb, int8 labels, uint8 boundary, fp16 depth) and are cast
back on the device. The latest checkpoint is saved at the end;
``--eval-only`` restores it and runs only the held-out evaluation: mIoU and
the instance detection rate (IoU >= 0.5, greedy) through
``SegmentationNode``, logged and written per class to
``per_class[_nomerge][_aN].json``. The UNet comes initialised, where JAX's
script draws a batch for flax's init first: the batch order and the
augmentation draws of a seed differ from that script's, while the
evaluation of the same parameters is the same. The script's data-parallel
``shard_map`` step is not ported (one card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--n-frames", type=int, default=800)
    parser.add_argument("--n-val-frames", type=int, default=50)
    parser.add_argument("--image-shape", type=int, nargs=2,
                        default=(240, 320))
    parser.add_argument("--n-objects", type=int, nargs=2, default=(4, 10))
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--widths", type=int, nargs="+",
                        default=(32, 64, 128, 256))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--no-boundary", action="store_true",
        help="no instance-boundary head (one component per class)")
    parser.add_argument(
        "--use-depth", action="store_true",
        help="RGB-D input: depth enters as a fourth channel")
    parser.add_argument(
        "--no-augment", action="store_true",
        help="no photometric augmentation (contrast / HSV / blur / "
        "resolution)")
    parser.add_argument(
        "--eval-only", action="store_true",
        help="skip training; restore the latest checkpoint from --out and "
        "run the held-out evaluation")
    parser.add_argument(
        "--no-merge", action="store_true",
        help="no merge_occlusion_splits at instancing time")
    parser.add_argument(
        "--fg-weight", type=float, default=1.0,
        help="foreground pixel weight in the class CE (1.0 = plain mean)")
    parser.add_argument(
        "--min-area", type=int, default=50,
        help="instancing min component area in px")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and the steps")
    return parser.parse_args(argv)


def quantize_batch(batch, use_depth: bool):
    """The batch as it ships to the device: uint8 rgb, int8 class labels
    (22 classes and the ignore label -1), uint8 boundary, fp16 depth."""
    small = dict(
        rgb=np.clip(batch["rgb"], 0, 255).astype(np.uint8),
        class_label=batch["class_label"].astype(np.int8),
        boundary=batch["boundary"].astype(np.uint8),
    )
    if use_depth:
        small["depth"] = batch["depth"].astype(np.float16)
    return small


def make_loss_fn(model, fg_weight: float = 1.0, forward=None):
    """``loss_fn(small_batch) -> (loss, (class loss, boundary loss))`` on
    a batch of ``quantize_batch``, cast back on the model's device;
    ``forward`` is the module that runs the forward (a DDP wrapper of
    ``model``; default ``model``)."""
    from ..models.segmentation import boundary_loss, segmentation_loss

    forward = model if forward is None else forward

    def loss_fn(small):
        device = next(model.parameters()).device
        b = {k: torch.as_tensor(v, device=device) for k, v in small.items()}
        kw = {}
        if model.use_depth:
            kw["depth"] = b["depth"].to(torch.float32)
        out = forward(b["rgb"].to(torch.float32), **kw)
        labels = b["class_label"].to(torch.int32)
        if model.with_boundary:
            logits, blog = out
            l_cls = segmentation_loss(logits, labels, fg_weight=fg_weight)
            l_bnd = boundary_loss(blog, b["boundary"])
            return l_cls + l_bnd, (l_cls, l_bnd)
        l_cls = segmentation_loss(out, labels, fg_weight=fg_weight)
        return l_cls, (l_cls, torch.zeros_like(l_cls))

    return loss_fn


def make_train_step(state, fg_weight: float = 1.0, mesh=None):
    """``train_step(small_batch) -> loss`` (a detached device scalar): one
    Adam step of ``state`` (a ``training.TrainState``) on this rank's
    batch; under a process group (``mesh`` of ``parallel.data_mesh``) the
    forward runs under DDP, which averages the gradients over the ranks,
    and the loss returned is the ranks' mean."""
    from ..training.trainer import all_reduce_mean, wrap_ddp

    ddp = wrap_ddp(state.model, mesh)
    loss_fn = make_loss_fn(state.model, fg_weight, forward=ddp)

    def train_step(small):
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(small)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return all_reduce_mean({"loss": loss.detach()}, mesh)["loss"]

    train_step.ddp = ddp
    return train_step


def evaluate(model, args):
    """Held-out mIoU and detection rate of ``model`` on ``--n-val-frames``
    frames (seed ``--seed + 1``): ``(summary, per-class table)``."""
    from ..datasets.instance_segmentation import (
        SyntheticInstanceSegmentationDataset,
    )
    from ..models.segmentation import SegmentationNode, match_instances, miou

    val = SyntheticInstanceSegmentationDataset(
        split="val",
        n_frames=args.n_val_frames,
        image_shape=tuple(args.image_shape),
        n_objects=tuple(args.n_objects),
        format="instance",
        seed=args.seed + 1,
    )
    node = SegmentationNode(model, merge_splits=not args.no_merge,
                            min_area=args.min_area, device=args.device)
    mious, matched, n_gt, n_pred = [], 0, 0, 0
    per_class = {}  # cid -> [matched, gt, pred]
    for i in range(len(val)):
        ex = val.get_example(i)
        pred_label, pred_classes = node(
            ex["rgb"], ex["depth"] if args.use_depth else None)
        class_map_pred = np.zeros(pred_label.shape, np.int32)
        for pid, cid in pred_classes.items():
            class_map_pred[pred_label == pid] = cid
        mious.append(miou(class_map_pred, ex["class_label"]))
        gt_classes = {}
        for gid in np.unique(ex["instance_label"]):
            if gid < 0:
                continue
            sel = ex["instance_label"] == gid
            gt_classes[int(gid)] = int(ex["class_label"][sel][0])
        m, g, p = match_instances(pred_label, pred_classes,
                                  ex["instance_label"], gt_classes)
        matched += m
        n_gt += g
        n_pred += p
        for cid in set(gt_classes.values()) | set(pred_classes.values()):
            gt_c = {k: v for k, v in gt_classes.items() if v == cid}
            pr_c = {k: v for k, v in pred_classes.items() if v == cid}
            mc, gc, pc = match_instances(pred_label, pr_c,
                                         ex["instance_label"], gt_c)
            acc = per_class.setdefault(int(cid), [0, 0, 0])
            acc[0] += mc
            acc[1] += gc
            acc[2] += pc

    summary = {
        "validation/miou": float(np.mean(mious)),
        "validation/detection_rate": matched / max(n_gt, 1),
        "validation/precision": matched / max(n_pred, 1),
        "validation/n_gt": n_gt,
    }
    table = {
        str(cid): dict(detection=m / max(g, 1), precision=m / max(p, 1),
                       n_gt=g)
        for cid, (m, g, p) in sorted(per_class.items())
    }
    return summary, table


def per_class_name(args) -> str:
    name = "per_class_nomerge.json" if args.no_merge else "per_class.json"
    if args.min_area != 50:
        name = name.replace(".json", f"_a{args.min_area}.json")
    return name


def main(argv=None):
    """Train and evaluate; returns (state, the evaluation's summary)."""
    args = parse_args(argv)
    from .. import parallel, training
    from ..datasets.instance_segmentation import (
        SyntheticInstanceSegmentationDataset,
    )
    from ..datasets.rgbd_pose_estimation.augmentation import augment_rgb
    from ..models.segmentation import UNetSegmentation

    parallel.maybe_initialize(backend="gloo" if args.device == "cpu"
                              else None)  # a no-op outside torchrun
    mesh = parallel.data_mesh(args.device)
    primary = parallel.is_primary()
    ds = SyntheticInstanceSegmentationDataset(
        split="train",
        n_frames=args.n_frames,
        image_shape=tuple(args.image_shape),
        n_objects=tuple(args.n_objects),
        format="instance",
        seed=args.seed,
    )
    aug_rng = np.random.RandomState(args.seed + 99)

    def transform(ex):
        if not args.no_augment:
            ex = dict(ex, rgb=augment_rgb(
                np.clip(ex["rgb"], 0, 255).astype(np.uint8), aug_rng
            ).astype(np.float32))
        return ex

    loader = training.BatchLoader(
        ds, args.batch_size, transform, shuffle=True,
        shard=parallel.local_batch_slice(args.batch_size, mesh))
    torch.manual_seed(args.seed)
    model = UNetSegmentation(n_class=22, widths=tuple(args.widths),
                             with_boundary=not args.no_boundary,
                             use_depth=args.use_depth).to(mesh.device)
    state = training.create_train_state(model, args.lr)

    log = training.LogReport(args.out) if primary else None
    if not args.eval_only and primary:  # keep a training run's args.json
        training.write_args(args.out, vars(args))
    ckpt = training.CheckpointManager(args.out) if primary else None
    if args.eval_only:
        if primary and ckpt.restore_latest(state) is None:
            raise SystemExit(f"--eval-only: no checkpoint under {args.out}")
        args.steps = 0
    else:
        train_step = make_train_step(state, fg_weight=args.fg_weight,
                                     mesh=mesh)

    k = 0
    while k < args.steps:
        for batch in loader:
            loss = train_step(quantize_batch(batch, args.use_depth))
            k += 1
            if k % 50 == 0 and primary:
                value = float(loss)
                log.report({"main/loss": value}, step=k)
                print(f"step {k}: loss={value:.4f}", flush=True)
            if k >= args.steps:
                break
    parallel.barrier()
    if not primary:  # rank 0 alone saves and evaluates
        return state, {}
    if not args.eval_only:
        ckpt.save_latest(state, k)

    summary, table = evaluate(model, args)
    log.report(summary, step=k)
    print("validation:", {k2: round(v, 4) for k2, v in summary.items()})
    worst = sorted(table.items(), key=lambda kv: kv[1]["detection"])[:5]
    table["_summary"] = {
        k2.split("/")[-1]: round(v, 6) if isinstance(v, float) else v
        for k2, v in summary.items()
    }
    with open(os.path.join(args.out, per_class_name(args)), "w") as f:
        json.dump(table, f, indent=1)
    print("worst classes:",
          [(c, round(v["detection"], 2)) for c, v in worst])
    return state, summary


if __name__ == "__main__":
    main(sys.argv[1:])
