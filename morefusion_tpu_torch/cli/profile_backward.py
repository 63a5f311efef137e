"""Ablate the train step's backward to locate its time.

    python -m morefusion_tpu_torch.cli.profile_backward [--batch-size 16]
        [--steps 15] [--align-only] [--device cuda] [--tiny]
        [--image-size 256]

Port of ``examples/profile_backward.py``, plus ``--device`` (default
``cuda``), ``--tiny`` and ``--image-size``. In one process, on
``profile_train.make_batch``'s batch, the full-width step with the
occupancy branch and the occupancy loss term (the min_dist kernel) and
ADD-S (the knn kernel), as variants:

  A. the full fp32 step (the baseline);
  B. the interpolation's grid gradient zeroed
     (:func:`interpolate_no_grid_grad`): the upper bound of any win on
     the interpolation's backward scatter;
  C. the loss forced asymmetric: ``use_symmetric`` off and ADD-S not
     computed (``functions.average_distance_both`` patched to return ADD
     twice), so no knn runs;
  D. both B and C;
  E. bf16 compute;
  F. the sorted interpolation (``interpolate_voxel_grid_sorted``);
  G, H. ``point_widths=(64, 8, 96, 16)`` in fp32 and bf16: conv3 reads
     128 channels in place of 160. New parameter shapes: these start from
     a fresh initialisation, as in JAX.

Each prints its ms a step (CUDA events around ``--steps`` queued steps;
the host clock on the CPU), its TFLOP/s where ``FlopCounterMode`` counts
FLOPs (matrix products and convolutions only; see ``profile_train``) and
its knn and min_dist launches over the variant's steps; then the
attribution lines (A - B, A - C, ...). Every patch is of this port's
modules and is undone in a ``finally``. ``--align-only`` runs A, G and H.
``main`` returns each variant's row.
"""

from __future__ import annotations

import argparse
import time
from unittest import mock

import torch

from ..functions import loss as loss_module
from ..functions import voxelization as vox


class InterpolateNoGridGrad(torch.autograd.Function):
    """``interpolate_voxel_grid`` whose backward gives the points their
    gradient and the grid none."""

    @staticmethod
    def forward(ctx, grid, points, batch_indices):
        ctx.save_for_backward(grid, points, batch_indices)
        return vox.interpolate_voxel_grid(grid, points, batch_indices)

    @staticmethod
    def backward(ctx, grad_out):
        grid, points, batch_indices = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None, None
        with torch.enable_grad():
            p = points.detach().requires_grad_(True)
            out = vox.interpolate_voxel_grid(grid.detach(), p,
                                             batch_indices)
            (grad_points,) = torch.autograd.grad(out, p, grad_out)
        return None, grad_points, None


def interpolate_no_grid_grad(grid, points, batch_indices):
    """Variant B's interpolation: the forward of
    ``interpolate_voxel_grid``, no gradient to ``grid`` (the backward's
    scatter into the grid is gone)."""
    return InterpolateNoGridGrad.apply(grid, points, batch_indices)


def add_only(points, transform_true, transforms_pred):
    """Variant C's ``average_distance_both``: ADD in both places, so that
    no nearest-neighbour search runs."""
    add = loss_module.average_distance(points, transform_true,
                                       transforms_pred, False)
    return add, add


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--steps", type=int, default=15)
    parser.add_argument(
        "--align-only", action="store_true",
        help="run only A, G and H (the channel-alignment probe)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model")
    parser.add_argument("--tiny", action="store_true",
                        help="the test-sized model")
    parser.add_argument("--image-size", type=int, default=256,
                        help="the crops' height and width")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import functions
    from ..datasets import ProceduralModels
    from ..models import singleview_3d as sv3d
    from ..ops import knn
    from ..ops import min_dist as md
    from ..training import trainer as trainer_module
    from . import profile_train as pt

    device = torch.device(args.device)
    B, S = args.batch_size, args.image_size
    batch = pt.to_device(pt.make_batch(B, S, S), device)
    bank = trainer_module.CadPointBank.build(
        ProceduralModels(), pt.N_FG_CLASS, device=device)
    card = pt.card_name(device)
    print("device:", device, card, flush=True)
    rows = {}

    def run_variant(key, name, dtype, interp=None, symmetric=True, **mkw):
        patches = []
        if interp is not None:
            patches.append(mock.patch.object(sv3d, "interpolate_voxel_grid",
                                             interp))
        if not symmetric:
            patches.append(mock.patch.object(functions,
                                             "average_distance_both",
                                             add_only))
        for p in patches:
            p.start()
        try:
            model = pt.build_model(args.tiny, dtype, device, **mkw)
            state = trainer_module.create_train_state(model)
            step = trainer_module.make_train_step(
                model, bank, occupancy_loss_term=True)

            def one():
                return step(state, batch, symmetric)

            t0 = time.perf_counter()
            float(one()[1]["loss"])
            first_s = time.perf_counter() - t0
            flops = pt.count_flops(one)
            before = knn.nn_indices.launches, md.min_dist_voxels.launches
            t = pt.timeit(one, device, args.steps)
            n_calls = args.steps + 3  # timeit's warm-up calls count too
            launches = dict(
                nn_indices=knn.nn_indices.launches - before[0],
                min_dist_voxels=md.min_dist_voxels.launches - before[1],
                steps=n_calls)
            dt = (t["ms"] or t["host_ms"]) / 1e3
            tf = f" {flops / dt / 1e12:5.1f} TF/s" if flops else ""
            print(f"{name:44s} {dt * 1e3:7.1f} ms/step{tf} "
                  f"(first call {first_s:.0f}s; knn "
                  f"{launches['nn_indices']}, min_dist "
                  f"{launches['min_dist_voxels']} launches in {n_calls} "
                  f"steps)", flush=True)
            rows[key] = dict(name=name, ms=t["ms"], host_ms=t["host_ms"],
                             first_call_s=first_s, flops=flops,
                             launches=launches)
            return dt
        finally:
            for p in reversed(patches):
                p.stop()

    f32, b16 = torch.float32, torch.bfloat16
    a = run_variant("A", "A full fp32", f32)
    if not args.align_only:
        b = run_variant("B", "B fp32, interp grid-VJP zeroed", f32,
                        interp=interpolate_no_grid_grad)
        c = run_variant("C", "C fp32, asymmetric loss (no KNN)", f32,
                        symmetric=False)
        d = run_variant("D", "D fp32, both ablations", f32,
                        interp=interpolate_no_grid_grad, symmetric=False)
        e = run_variant("E", "E full bf16 compute", b16)
        f = run_variant("F", "F fp32, sorted-segment interp VJP", f32,
                        interp=vox.interpolate_voxel_grid_sorted)
    g = run_variant("G", "G fp32, conv3-in 128ch", f32,
                    point_widths=(64, 8, 96, 16))
    h = run_variant("H", "H bf16, conv3-in 128ch", b16,
                    point_widths=(64, 8, 96, 16))

    print(f"\n=== attribution (ms) on {card} ===")
    if not args.align_only:
        print(f"interp grid-VJP scatter : {1e3 * (a - b):7.1f}")
        print(f"ADD-S KNN fwd+bwd       : {1e3 * (a - c):7.1f}")
        print(f"both                    : {1e3 * (a - d):7.1f}")
        print(f"bf16-compute saving     : {1e3 * (a - e):7.1f}")
        print(f"sorted-VJP saving       : {1e3 * (a - f):7.1f} "
              f"(upper bound is A-B)")
    print(f"128ch-aligned fp32 delta: {1e3 * (a - g):7.1f}")
    print(f"128ch-aligned bf16 delta: {1e3 * (a - h):7.1f}")
    return rows


if __name__ == "__main__":
    main()
