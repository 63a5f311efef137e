#!/usr/bin/env python3
"""Time one ICC refine on phase 3's problem and count its launches.

    python3 tools/icc_refine_time.py [--root DIR] [--iterations 12 30]
                                     [--reps 10] [--device cuda]

Imports ``morefusion_tpu_torch`` from ``--root`` (default: this checkout),
so that two versions of the port can be compared on one card in one call,
in turns (other, this, this, other). The problem is the one phase 3 of
``chip_smoke.py`` refines: eight objects of 2048 points, a 32^3 grid. For
each iteration count it prints one JSON line:

- ``refine_ms``: the mean time of one ``IterativeCollisionCheck.refine``
  over ``--reps`` refines (host clock, the card synchronised before and
  after; the objects are built before the clock starts);
- ``n_iter`` (of the last refine), ``evaluations`` (the min-distance
  kernel's launches, one a loss evaluation, a refine on the mean) and
  ``ms_per_evaluation``;
- ``device_kernels``: the kernels torch.profiler records on the card in
  one more refine, in all and per evaluation of that refine; and
  ``host_ops``, the top-level PyTorch operators it records on the host
  (an optimizer's operators nest under its step and are not counted).

At 12 iterations or fewer the plateau rule cannot stop a refine (it needs
10 loss changes after the first loss and then 3 passes in a row), so every
version makes the same evaluations. Exits 1 without a card unless
``--device cpu``.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_scene_maker():
    """``make_icc_scene`` of this checkout's ``chip_smoke.py``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.make_icc_scene


def profile_refine(make, iterations, device, md):
    """Kernels on the card, top-level operators on the host and loss
    evaluations (min-distance launches) in one refine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    icc = make()
    md.min_dist_voxels.launches = 0
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        icc.refine(iterations=iterations)
        if device.type == "cuda":
            torch.cuda.synchronize()
    events = prof.events()
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    host_ops = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and e.cpu_parent is None and e.name.startswith("aten::"))
    return kernels, host_ops, md.min_dist_voxels.launches


def per(count, evaluations):
    return None if count is None or not evaluations else count / evaluations


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE,
                        help="checkout whose morefusion_tpu_torch runs")
    parser.add_argument("--iterations", type=int, nargs="+",
                        default=[12, 30])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--small", action="store_true",
                        help="4 objects of 256 points, 16^3 (a CPU check)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("icc_refine_time: no CUDA device", file=sys.stderr)
        return 1
    make_icc_scene = load_scene_maker()
    sys.path.insert(0, os.path.abspath(args.root))
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.ops import min_dist as md

    device = torch.device(args.device)
    N, M, V = (8, 2048, 32) if not args.small else (4, 256, 16)
    scene = make_icc_scene(4, N, M, V)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def make():
        return IterativeCollisionCheck(*scene, voxel_dim=V, max_points=M,
                                       device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    for iterations in args.iterations:
        make().refine(iterations=iterations)  # build and warm up
        iccs = [make() for _ in range(args.reps)]
        sync()
        md.min_dist_voxels.launches = 0
        t0 = time.perf_counter()
        for icc in iccs:
            _, _, n_iter = icc.refine(iterations=iterations)
        sync()
        sec = (time.perf_counter() - t0) / args.reps
        evaluations = md.min_dist_voxels.launches / args.reps
        try:
            kernels, host_ops, profiled = profile_refine(
                make, iterations, device, md)
        except RuntimeError as e:  # the profiler is optional evidence
            print(f"icc_refine_time: profiler failed: {e}", file=sys.stderr)
            kernels = host_ops = profiled = None
        print(json.dumps(dict(
            root=os.path.abspath(args.root), device=str(device), objects=N,
            points=M, voxel_dim=V, iterations=iterations,
            n_iter=int(n_iter), evaluations=evaluations,
            refine_ms=sec * 1e3, reps=args.reps,
            ms_per_evaluation=per(sec * 1e3, evaluations),
            profiled_evaluations=profiled, device_kernels=kernels,
            device_kernels_per_evaluation=per(kernels, profiled),
            host_ops=host_ops,
            host_ops_per_evaluation=per(host_ops, profiled))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
