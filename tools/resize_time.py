#!/usr/bin/env python3
"""Time the bilinear resize kernel against ``F.interpolate`` on the card.

    python3 tools/resize_time.py [--reps 20] [--batch 16]

At PSPNet's seven shapes at B = 16 (the pyramid's 512 channels from 1, 2,
3 and 6 up to 32^2; the x2 stages 1024 x 32^2, 256 x 64^2 and 64 x 128^2),
in fp32, prints one JSON line a shape and one for their sum:

- ``fwd_ms`` / ``bwd_ms``: the kernel's forward and backward launchers
  (``ops/resize.py``), ``lib_fwd_ms`` / ``lib_bwd_ms``: ``F.interpolate``
  and ``aten.upsample_bilinear2d_backward`` on the same tensors (the
  backward with its zero fill); each the mean over ``--reps`` queued calls
  between two CUDA events, after a warm-up;
- ``bound_ms``: the bytes each direction must move (the input read once,
  the output written once, or the reverse) over 3.35 TB/s.

The first line names the card and its power limit, and the kernels'
registers as ``ptxas`` reports them (the library is rebuilt for that).
Exits 1 without a card.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from morefusion_tpu_torch.ops import _build  # noqa: E402
from morefusion_tpu_torch.ops import resize as R  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# (C, H, W, h, w) of one PSPNet forward at 256^2 crops
SHAPES = [(512, 1, 1, 32, 32), (512, 2, 2, 32, 32), (512, 3, 3, 32, 32),
          (512, 6, 6, 32, 32), (1024, 32, 32, 64, 64),
          (256, 64, 64, 128, 128), (64, 128, 128, 256, 256)]


def cuda_ms(fn, reps):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    query = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    seconds, out = _build.build(ptxas_verbose=True)
    ptxas = [line.strip() for line in out.splitlines()
             if "registers" in line or "Compiling entry" in line]
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": query.stdout.strip(), "build_s": seconds,
            "ptxas": [p for p in ptxas if "resize" in p or "up2" in p
                      or "registers" in p]}


def time_shape(N, C, H, W, h, w, reps):
    dev = torch.device("cuda")
    x = torch.randn((N, C, H, W), device=dev)
    g = torch.randn((N, C, h, w), device=dev)
    y = torch.empty_like(g)
    gx = torch.empty_like(x)
    fwd = cuda_ms(lambda: R._launch("mfk_resize_forward", x, y, (H, W),
                                    (h, w)), reps)
    bwd = cuda_ms(lambda: R._launch("mfk_resize_backward", g, gx, (H, W),
                                    (h, w)), reps)
    lib_fwd = cuda_ms(lambda: R.resize_bilinear_plain(x, h, w), reps)
    lib_bwd = cuda_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(
        g, [h, w], [N, C, H, W], False, None, None), reps)
    nbytes = (x.numel() + g.numel()) * x.element_size()
    return {"shape": [N, C, H, W, h, w], "fwd_ms": fwd, "bwd_ms": bwd,
            "lib_fwd_ms": lib_fwd, "lib_bwd_ms": lib_bwd,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(card_line()), flush=True)
    total = dict.fromkeys(("fwd_ms", "bwd_ms", "lib_fwd_ms", "lib_bwd_ms",
                           "bound_ms"), 0.0)
    for C, H, W, h, w in SHAPES:
        line = time_shape(args.batch, C, H, W, h, w, args.reps)
        for key in total:
            total[key] += line[key]
        print(json.dumps(line), flush=True)
    print(json.dumps({"total": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
