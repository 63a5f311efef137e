"""Readings that the correctness limits are set from, on the card.

    python -m mfbench.calibrate --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds 3] [--out FILE]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, the program's answers and the plain reference's in
float32, and the gaps between them (the sound readings). For each control
seed also the gaps of the reference computed in TF32 put in the program's
place (the control), and for a training cell those of the reference with
half of each batch left out of the loss, the mean taken over the rest (a
planted fault). Prints one JSON line a seed, and with ``--out`` appends
them there. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import torch

from mfbench import harness

ROOT = Path(__file__).resolve().parent.parent


def control_answers(cell, want):
    """A reference's answers in the program's form."""
    if cell.spec["driver"] == "train_step":
        return want
    out = []
    for ref in want:
        answer = {"poses": ref["poses"]}
        for key in ("start", "refined", "losses"):
            if key in ref:
                answer[key] = ref[key]
        out.append((None, answer))
    return out


def half_batch(fn):
    """``fn`` (a loss over lanes) over the first half of the lanes."""

    def wrapped(**kw):
        B = kw["quaternion_pred"].shape[0]
        return fn(**{k: v[: B // 2] for k, v in kw.items()})

    return wrapped


def readings(root, workload, seed, seconds, control, device):
    from mfbench.reference.models import losses as plain_losses

    cell = harness.load_cell(root, workload)
    driver = harness.load_module(
        root / "mfbench" / "drivers" / f"{cell.spec['driver']}.py",
        cell.spec["driver"])
    record = harness.Record()
    ctx = harness.Context(root=root, cell=cell, seed=seed, device=device,
                          record=record,
                          tracer=harness.Tracer(record, False, device))
    t0 = time.perf_counter()
    st = driver.setup(ctx)
    driver.window(st, ctx, seconds)
    got = driver.answers(st, ctx)
    t1 = time.perf_counter()
    want = driver.reference(st, ctx, got)
    t2 = time.perf_counter()
    out = {"workload": workload, "seed": seed,
           "units": len(record.units), "setup_and_window_s": t1 - t0,
           "reference_s": t2 - t1,
           "sound": {n: v for n, v, _ in driver.compare(got, want, ctx)}}
    if hasattr(driver, "diagnose"):
        out["diagnosis"] = driver.diagnose(got, want)
    if control:
        tf32 = driver.reference(st, ctx, got, tf32=True)
        out["control_tf32"] = {n: v for n, v, _ in driver.compare(
            control_answers(cell, tf32), want, ctx)}
        if hasattr(driver, "numbers"):
            out["control_numbers"] = driver.numbers(tf32, want)
        if cell.spec["driver"] == "train_step":
            with mock.patch.object(plain_losses, "pose_loss",
                                   half_batch(plain_losses.pose_loss)), \
                    mock.patch.object(plain_losses, "occupancy_loss",
                                      half_batch(
                                          plain_losses.occupancy_loss)):
                half = driver.reference(st, ctx, got)
            out["fault_half_batch"] = driver.numbers(half, want)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("mfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in list(args.seeds) + [s for s in args.control_seeds
                                    if s not in args.seeds]:
        line = readings(ROOT, args.workload, seed, args.seconds,
                        seed in args.control_seeds, device)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
