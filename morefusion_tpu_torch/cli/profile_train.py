"""Profile the SingleView3D train step: per-stage times and fp32 against bf16.

    python -m morefusion_tpu_torch.cli.profile_train [--batch-size 16]
        [--steps 20] [--trace-dir DIR] [--device cuda] [--tiny]
        [--image-size 256]

Port of ``examples/profile_train.py``, plus ``--device`` (default
``cuda``), ``--tiny`` (the test-sized model) and ``--image-size``. On a
synthetic batch at the real shapes (``make_batch``: B = 16, 256^2, 1000
points, 32^3 grids; no dataset needed) it times:

- the full train step (the occupancy branch, ADD-S loss, no occupancy
  loss term) in fp32 and in bf16 compute, with the time of its first call:
  the data-parallel step (``make_dp_train_step`` under a process group of
  this one process, ``nccl`` on the card, ``gloo`` on the CPU; DDP's
  gradient all-reduce included) as the JAX script times
  ``make_dp_train_step``, and beside it the bare single-device step
  (``make_train_step``), in turns, so that DDP's own cost shows;
- the forward alone, in both dtypes;
- the 2D backbone (ResNet + PSPNet), forward and forward + backward; the
  voxel branch (voxelization, 3D convs, interpolation), forward and
  forward + backward; the pose towers, forward; the ADD(-S) loss, forward.

Each time is the mean of ``--steps`` calls queued back to back (a train
step's: of two turns of half as many, in turns with the other step): ``ms`` by
CUDA events around them (None on the CPU) and ``host_ms`` by the host
clock from the first call to a synchronise after the last. The FLOP count
replaces XLA's cost analysis: ``torch.utils.flop_counter.FlopCounterMode``
over one fp32 step counts the matrix products and convolutions that
PyTorch dispatches (forward and backward); the elementwise work, the
scatters and the hand-written kernels behind ``ctypes`` (knn here) are
invisible to it, so it is a lower bound. The achieved rate is printed
beside the card's name and power limit. ``--trace-dir`` writes a
``torch.profiler`` Chrome trace of the backbone through
``utils.profiling.trace``. ``main`` returns the results, in ms.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np

N_FG_CLASS = 21


def make_batch(B, H=256, W=256, V=32, seed=0):
    """The JAX script's synthetic batch (NumPy, the same draws)."""
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 255, (B, H, W, 3)).astype(np.float32)
    pcd = rng.uniform(-0.2, 0.2, (B, H, W, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    hole = rng.rand(B, H, W) < 0.35
    pcd[hole] = np.nan
    q = rng.randn(B, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        class_id=rng.randint(1, 22, B).astype(np.int32),
        rgb=rgb,
        pcd=pcd,
        quaternion_true=q,
        translation_true=np.float32(
            rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.8]
        ),
        origin=np.float32(rng.uniform(-0.2, 0.0, (B, 3)) + [0, 0, 0.7]),
        pitch=np.full(B, 0.01, np.float32),
        grid_target=(rng.rand(B, V, V, V) < 0.05).astype(np.float32),
        grid_nontarget_empty=(rng.rand(B, V, V, V) < 0.3).astype(
            np.float32
        ),
    )


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device, steps, warmup=3):
    """``dict(ms, host_ms)``: the mean of ``steps`` queued calls of ``fn``
    after ``warmup`` calls, by CUDA events (None on the CPU) and by the
    host clock ending in a synchronise."""
    import torch

    for _ in range(warmup):
        fn()
    sync(device)
    events = None
    if device.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    if events:
        events[1].record()
    sync(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    ms = events[0].elapsed_time(events[1]) / steps if events else None
    return dict(ms=ms, host_ms=host_ms)


def build_model(tiny, compute_dtype, device, **kw):
    """A seeded SingleView3D with the occupancy branch (test-sized with
    ``tiny``) on ``device``."""
    import torch

    from .. import models

    torch.manual_seed(0)
    if tiny:
        model = models.tiny_singleview3d(
            N_FG_CLASS, with_occupancy=True, compute_dtype=compute_dtype,
            **kw)
    else:
        model = models.SingleView3D(
            n_fg_class=N_FG_CLASS, with_occupancy=True,
            compute_dtype=compute_dtype, **kw)
    return model.to(device)


def to_device(batch, device):
    import torch

    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def count_flops(fn) -> int:
    """FLOPs of one call of ``fn`` as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--trace-dir", default=None,
                        help="optional torch.profiler trace output dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model")
    parser.add_argument("--tiny", action="store_true",
                        help="the test-sized model")
    parser.add_argument("--image-size", type=int, default=256,
                        help="the crops' height and width")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from .. import parallel
    from ..datasets import ProceduralModels
    from ..models import losses as losses_module
    from ..models.heads import select_class
    from ..training import trainer as trainer_module

    device = torch.device(args.device)
    made_group = parallel.distributed.initialize_single(args.device)
    mesh = parallel.data_mesh(args.device)
    card = card_name(device)
    print("device:", device, card, "| tf32 convs / matmul:",
          torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32, flush=True)
    B, S = args.batch_size, args.image_size
    batch = to_device(make_batch(B, S, S), device)
    bank = trainer_module.CadPointBank.build(
        ProceduralModels(), N_FG_CLASS, device=device)
    results, bare, first_call_s = {}, {}, {}
    flops = None

    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = build_model(args.tiny, dtype, device)
        state = trainer_module.create_train_state(model)
        steps = dict(
            dp=trainer_module.make_dp_train_step(
                model, bank, mesh, occupancy_loss_term=False),
            bare=trainer_module.make_train_step(
                model, bank, occupancy_loss_term=False))
        step = steps["dp"]

        t0 = time.perf_counter()
        _, metrics = step(state, batch, True)
        float(metrics["loss"])
        first_call_s[name] = time.perf_counter() - t0
        print(f"[{name}] first call: {first_call_s[name]:.1f}s", flush=True)
        if name == "fp32":
            flops = count_flops(lambda: step(state, batch, True))

        timed = {"dp": [], "bare": []}
        for kind in ("dp", "bare", "bare", "dp"):  # in turns
            timed[kind].append(timeit(
                lambda: steps[kind](state, batch, True), device,
                max(args.steps // 2, 1)))
        for kind, out in (("dp", results), ("bare", bare)):
            out[f"train_step_{name}"] = r = {
                k: None if timed[kind][0][k] is None
                else (timed[kind][0][k] + timed[kind][1][k]) / 2
                for k in ("ms", "host_ms")}
            dt = (r["ms"] or r["host_ms"]) / 1e3
            print(f"[{name}] {kind} train step: {dt * 1e3:.1f} ms "
                  f"({B / dt:.1f} samples/s)", flush=True)

        generator = torch.Generator(device=device).manual_seed(0)

        def fwd():
            with torch.no_grad():
                quat, trans, conf = model(
                    class_id=batch["class_id"], rgb=batch["rgb"],
                    pcd=batch["pcd"], pitch=batch["pitch"],
                    origin=batch["origin"],
                    grid_nontarget_empty=batch["grid_nontarget_empty"],
                    generator=generator)
                return quat.sum() + trans.sum() + conf.sum()

        results[f"fwd_{name}"] = r = timeit(fwd, device, args.steps)
        print(f"[{name}] forward only: {(r['ms'] or r['host_ms']):.1f} ms",
              flush=True)
        del model, state, step, steps

    # ---- the stages, of the fp32 model ----
    model = build_model(args.tiny, torch.float32, device)
    params = [p for p in model.parameters() if p.requires_grad]
    slow = max(args.steps // 2, 5)

    def backbone():
        with torch.no_grad():
            return model.pspnet_extractor(model.resnet_extractor(
                batch["rgb"]))

    def backbone_grad():
        out = model.pspnet_extractor(model.resnet_extractor(batch["rgb"]))
        return torch.autograd.grad(out.sum(), params, allow_unused=True)

    results["backbone_fwd"] = timeit(backbone, device, args.steps)
    results["backbone_fwdbwd"] = timeit(backbone_grad, device, slow)

    # the voxel branch: sampled values and points -> fused point features
    P = model.n_point
    vals = torch.as_tensor(np.random.RandomState(0).randn(B, P, 32),
                           dtype=torch.float32, device=device)
    pts = torch.as_tensor(np.random.RandomState(1).uniform(0, 32, (B, P, 3)),
                          dtype=torch.float32, device=device)
    gne = batch["grid_nontarget_empty"]

    def voxel_branch():
        with torch.no_grad():
            return model._extract(vals, pts, gne)

    def voxel_branch_grad():
        out = model._extract(vals, pts, gne)
        return torch.autograd.grad(out.sum(), params, allow_unused=True)

    results["voxel_branch_fwd"] = timeit(voxel_branch, device, args.steps)
    results["voxel_branch_fwdbwd"] = timeit(voxel_branch_grad, device, slow)

    feat = voxel_branch()
    fg = batch["class_id"].long() - 1

    def towers():
        with torch.no_grad():
            return select_class(*model.heads(feat), fg)

    results["towers_fwd"] = timeit(towers, device, args.steps)

    quat, trans, conf = towers()
    cid = batch["class_id"].long()

    def loss_only():
        with torch.no_grad():
            return losses_module.pose_loss(
                quaternion_pred=quat, translation_pred=trans,
                confidence_pred=conf,
                quaternion_true=batch["quaternion_true"],
                translation_true=batch["translation_true"],
                cad_points=bank.points[cid], symmetric=bank.symmetric[cid])

    results["add_loss_fwd"] = timeit(loss_only, device, args.steps)

    if args.trace_dir:
        from ..utils import profiling

        with profiling.trace(args.trace_dir):
            for _ in range(3):
                backbone()
            sync(device)
        print("trace written to", args.trace_dir)

    print("\n=== profile summary (ms; CUDA events, else the host clock) ===")
    for k, v in results.items():
        print(f"{k:24s} {(v['ms'] or v['host_ms']):8.1f} "
              f"(host {v['host_ms']:.1f})")
    for k, v in bare.items():
        print(f"{'bare_' + k:24s} {(v['ms'] or v['host_ms']):8.1f} "
              f"(host {v['host_ms']:.1f}; without DDP)")

    dt = results["train_step_fp32"]
    dt = (dt["ms"] or dt["host_ms"]) / 1e3
    print(f"\nstep flops (FlopCounterMode: matmuls and convolutions): "
          f"{flops / 1e9:.1f} G")
    print(f"achieved: {flops / dt / 1e12:.2f} TFLOP/s on {card}")
    if made_group:
        parallel.distributed.dist.destroy_process_group()
    return dict(results=results, bare_results=bare,
                first_call_s=first_call_s,
                step_flops=flops, tflops_per_s=flops / dt / 1e12,
                card=card)


if __name__ == "__main__":
    main()
