"""Self-supervised backbone pretraining on procedural crops (RotNet).

    python -m morefusion_tpu_torch.cli.pretrain_backbone --out DIR \\
        --data PACKED_DIR [PACKED_DIR ...] [--steps 3000] [--device cuda]

The flags of ``examples/pretrain_backbone.py``, plus ``--device`` (default
``cuda``). The ``DilatedResNet18`` that SingleView3D and PoseNet use as
``resnet_extractor`` (at ``--width``, bf16 compute) learns to tell a
crop's 0 / 90 / 180 / 270 degree rotation (Gidaris et al. 2018): its
features are mean-pooled in fp32 into a 4-way ``Linear``. Crops come from
the ``rgb.npy`` memmaps of packed sets; ``--n-val`` of them are held out
for the pretext accuracy, drawn first from ``np.random.default_rng(seed)``,
which then draws each batch's crops and rotations in the JAX script's
order. Adam on a warmup-cosine schedule (0 -> ``--lr`` over ``warmup =
min(--warmup-steps, max(steps // 10, 1))`` steps, then down to 0 at
``max(steps, warmup + 1)``). Rows of ``log.jsonl`` carry ``val_acc``,
``train_acc_50`` and ``elapsed``. The backbone is exported as
``backbone_bf16.npz`` with keys ``['resnet_extractor'][...]`` in the JAX
package's archive format, which ``cli.train --pretrained-backbone`` and the
JAX ``train.py`` both graft.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--data", nargs="+", required=True,
                   help="packed store dirs (rgb.npy memmaps)")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--width", type=int, default=64,
                   help="DilatedResNet18 base width (flagship default 64)")
    p.add_argument("--n-val", type=int, default=512)
    p.add_argument("--eval-interval", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and the steps")
    return p.parse_args(argv)


class RotNet(nn.Module):
    """``(B, H, W, 3)`` uint8 crops -> rotation logits ``(B, 4)``; the
    backbone's attribute name is the pose models' so that its parameters
    graft one to one."""

    def __init__(self, base_width: int = 64):
        super().__init__()
        from ..models.layers import Linear
        from ..models.resnet import DilatedResNet18

        self.resnet_extractor = DilatedResNet18(
            base_width=base_width, compute_dtype=torch.bfloat16)
        self.rot_head = Linear(8 * base_width, 4)

    def forward(self, rgb):
        h = self.resnet_extractor(rgb)  # (B, 8w, H/8, W/8)
        return self.rot_head(h.to(torch.float32).mean(dim=(2, 3)))


def rotnet_loss(model, rgb, label):
    """(mean softmax cross-entropy, accuracy) of one batch."""
    logits = model(rgb)
    loss = F.cross_entropy(logits, label)
    acc = (logits.argmax(dim=-1) == label).to(torch.float32).mean()
    return loss, acc


def learning_rate(args):
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup,
    max(steps, warmup + 1))`` (end value 0) of the JAX script."""
    from ..training.trainer import warmup_cosine_decay_schedule

    warmup = min(args.warmup_steps, max(args.steps // 10, 1))
    return warmup_cosine_decay_schedule(
        0.0, args.lr, warmup, max(args.steps, warmup + 1))


class Crops:
    """The packed sets' crops as one index space, the JAX script's draws
    (held-out split, batch indices, rotations) from one ``default_rng``."""

    def __init__(self, dirs, n_val: int, seed: int):
        self.rgbs = [np.load(os.path.join(d, "rgb.npy"), mmap_mode="r")
                     for d in dirs]
        self.sizes = np.array([len(r) for r in self.rgbs])
        total = int(self.sizes.sum())
        self.rng = np.random.default_rng(seed)
        self.val_idx = self.rng.choice(total, size=min(n_val, total),
                                       replace=False)
        val_mask = np.zeros(total, bool)
        val_mask[self.val_idx] = True
        self.train_idx = np.nonzero(~val_mask)[0]

    def fetch(self, global_idx):
        out = np.empty((len(global_idx),) + self.rgbs[0].shape[1:],
                       np.uint8)
        ends = np.cumsum(self.sizes)
        for j, g in enumerate(global_idx):
            s = int(np.searchsorted(ends, g, side="right"))
            local = int(g - (ends[s - 1] if s else 0))
            out[j] = self.rgbs[s][local]
        return out

    def make_batch(self, idx):
        """Crops ``idx``, each turned by a drawn multiple of 90 degrees:
        ``(rgb (B, H, W, 3) uint8, k (B,) int64)``."""
        rgb = self.fetch(idx)
        ks = self.rng.integers(0, 4, size=len(idx))
        rot = np.stack([np.rot90(im, k) for im, k in zip(rgb, ks)])
        return rot, ks.astype(np.int64)

    def train_batch(self, batch_size: int):
        idx = self.rng.choice(self.train_idx, size=batch_size,
                              replace=False)
        return self.make_batch(idx)


def val_accuracy(model, crops, batch_size: int, device):
    """Rotation accuracy on the held-out crops, whole batches only."""
    hits = n = 0
    with torch.no_grad():
        for i in range(0, len(crops.val_idx), batch_size):
            chunk = crops.val_idx[i:i + batch_size]
            if len(chunk) < batch_size:
                break
            rot, ks = crops.make_batch(chunk)
            pred = model(torch.from_numpy(rot).to(device)).argmax(dim=-1)
            hits += int((pred.cpu().numpy() == ks).sum())
            n += len(chunk)
    return hits / max(n, 1)


def main(argv=None):
    """Pretrain and export; returns (model, the last ``log.jsonl`` row)."""
    args = parse_args(argv)
    from ..training.checkpoints import export_backbone_npz
    from ..training.trainer import create_train_state

    device = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=1)

    crops = Crops(args.data, args.n_val, args.seed)
    print(f"pretrain crops: {crops.sizes.tolist()} "
          f"(total {int(crops.sizes.sum())})", flush=True)
    torch.manual_seed(args.seed)
    model = RotNet(base_width=args.width).to(device)
    state = create_train_state(model, learning_rate(args))

    log_path = os.path.join(args.out, "log.jsonl")
    t0 = time.time()
    running, row = [], None
    for it in range(1, args.steps + 1):
        rot, ks = crops.train_batch(args.batch_size)
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc = rotnet_loss(model, torch.from_numpy(rot).to(device),
                                torch.from_numpy(ks).to(device))
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        running.append(float(acc))
        if it % 50 == 0:
            print(f"step {it}: loss={float(loss.detach()):.4f} "
                  f"acc(train,50)={np.mean(running[-50:]):.3f}", flush=True)
        if it % args.eval_interval == 0 or it == args.steps:
            va = val_accuracy(model, crops, args.batch_size, device)
            row = {"step": it, "val_acc": va,
                   "train_acc_50": float(np.mean(running[-50:])),
                   "elapsed": time.time() - t0}
            with open(log_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(f"step {it}: val rotation acc {va:.3f}", flush=True)

    out_npz = os.path.join(args.out, "backbone_bf16.npz")
    export_backbone_npz(model, out_npz)
    print(f"exported backbone subtree to {out_npz}", flush=True)
    return model, row


if __name__ == "__main__":
    main(sys.argv[1:])
