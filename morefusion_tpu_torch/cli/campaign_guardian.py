"""Bank a training campaign's checkpoints into git as soon as they improve.

    python -m morefusion_tpu_torch.cli.campaign_guardian --run-dir RUN
        --tag TAG [--pid PID] [--interval 120] [--min-delta 0.002]

Port of ``examples/campaign_guardian.py`` (the reference's role: chainer's
snapshot extensions, ``examples/ycb_video/singleview_3d/train.py:434-461``,
plus a git step, so that a lost machine loses no banked checkpoint):

- polls ``<run-dir>/log.json`` for the best ``main/add_or_add_s/auc``;
- whenever it improves by at least ``--min-delta`` over the last banked
  value, copies ``snapshot_model_best_validation_main_auc.npz`` (which
  ``CheckpointManager.save_best`` writes on every improvement) to
  ``RESULTS/<tag>_best_bf16.npz`` with ``<tag>_log.json`` and
  ``<tag>_args.json``, and commits the three to the repository at
  ``REPO``;
- exits once the ``--pid`` process is gone, after a last bank of any
  improvement however small; ``main`` returns the last banked AUC.

``REPO`` (this checkout) and ``RESULTS`` (its ``docs/results``) are module
constants. Host only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
RESULTS = os.path.join(REPO, "docs", "results")
KEY = "main/add_or_add_s/auc"


def best_val_auc(run_dir):
    """(best AUC, its row) of ``log.json``, or (None, None)."""
    path = os.path.join(run_dir, "log.json")
    if not os.path.exists(path):
        return None, None
    try:
        with open(path) as f:
            rows = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None, None  # a log being written: try again next poll
    best, best_row = None, None
    for r in rows:
        v = r.get(KEY)
        if v is not None and (best is None or v > best):
            best, best_row = v, r
    return best, best_row


def pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def bank(run_dir, tag, best, row):
    """Copy the best archive and the run's logs into ``RESULTS`` and
    commit them; False when the archive is missing."""
    src = os.path.join(
        run_dir, "snapshot_model_best_validation_main_auc.npz"
    )
    if not os.path.exists(src):
        print(f"[guardian] best improved to {best:.4f} but {src} missing",
              flush=True)
        return False
    shutil.copyfile(src, os.path.join(RESULTS, f"{tag}_best_bf16.npz"))
    for name in ("log.json", "args.json"):
        p = os.path.join(run_dir, name)
        if os.path.exists(p):
            shutil.copyfile(p, os.path.join(RESULTS, f"{tag}_{name}"))
    files = [
        os.path.join(RESULTS, f"{tag}_best_bf16.npz"),
        os.path.join(RESULTS, f"{tag}_log.json"),
        os.path.join(RESULTS, f"{tag}_args.json"),
    ]
    files = [f for f in files if os.path.exists(f)]
    msg = (
        f"{tag}: bank best checkpoint (val ADD(-S) AUC {best:.4f}, "
        f"epoch {row.get('epoch', -1):.1f})"
    )
    try:
        subprocess.run(["git", "add"] + files, cwd=REPO, check=True)
        r = subprocess.run(
            ["git", "commit", "-m", msg, "--only"] + files,
            cwd=REPO, capture_output=True, text=True,
        )
        print(f"[guardian] {msg}: commit rc={r.returncode}", flush=True)
        if r.returncode != 0:
            print(r.stdout + r.stderr, flush=True)
    except (OSError, subprocess.CalledProcessError) as e:
        # a failed git call must not end the watch
        print(f"[guardian] git failed: {e}", flush=True)
    return True


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--pid", type=int, default=None,
                    help="training PID; exit once it is gone")
    ap.add_argument("--interval", type=float, default=120.0)
    ap.add_argument("--min-delta", type=float, default=0.002,
                    help="bank only when best improves by this much "
                    "(keeps commit noise down; final bank on exit)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    banked = None
    while True:
        best, row = best_val_auc(args.run_dir)
        if best is not None and (banked is None
                                 or best > banked + args.min_delta):
            if bank(args.run_dir, args.tag, best, row):
                banked = best
        if args.pid is not None and not pid_alive(args.pid):
            # the last pass: bank any improvement, however small
            best, row = best_val_auc(args.run_dir)
            if best is not None and (banked is None or best > banked):
                if bank(args.run_dir, args.tag, best, row):
                    banked = best
            print("[guardian] training PID gone; exiting", flush=True)
            return banked
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
