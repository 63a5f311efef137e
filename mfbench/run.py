"""Run one cell of the benchmark once, on an NVIDIA GPU.

    python -m mfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the card's name, power limit and device
count, then, as its last line, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device`` and, traced, ``breakdown``; last in it
``checks``, each number the correctness check compared with its limit, as
also the last lines on standard error. Exits non-zero, printing no result,
where CUDA is missing or has fewer devices than the cell asks for, or where
JAX or the JAX package is loaded when the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from mfbench import harness

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of each card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return "; ".join(out.splitlines())


def main(argv=None) -> int:
    started = harness.process_start()
    args = parse_args(argv)
    import torch

    cell = harness.load_cell(ROOT, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available():
        print("mfbench: CUDA is not available; this benchmark runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"mfbench: {args.workload} needs {chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; devices: {torch.cuda.device_count()}",
          flush=True)
    # one host thread for PyTorch's own CPU work: the card's host is
    # shared, and idle worker threads spinning beside the launching
    # thread make the host-bound cells' runs spread
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = harness.execute(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        device, started=started, cell=cell)
    banned = harness.loaded_banned()
    if banned:
        print(f"mfbench: loaded after the window: {', '.join(banned)}",
              file=sys.stderr)
        return 3
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
