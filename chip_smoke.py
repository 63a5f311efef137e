#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``morefusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu  # rehearsal on the CPU, reduced size

Builds the CUDA kernels from ``morefusion_tpu_torch/csrc`` with ``nvcc``,
then runs four phases, each printing one JSON line:

1. kernel vs plain: the min-distance kernel against its plain PyTorch
   version at the ICC shapes and at edge cases;
2. serving: ``PoseEstimationNode.estimate`` with the committed occupancy
   checkpoint at full width on one synthetic 480x640 RGB-D frame with four
   instances, against the same node on the CPU, then timed;
3. ICC: ``IterativeCollisionCheck.refine`` (30 iterations) on eight
   synthetic objects of 2048 points, against the same refine with the
   plain version, then timed; its kernel launches are counted;
4. kernel timing at the ICC shapes, beside the plain version, one PyTorch
   yardstick and the card's bound.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero; it also does so, printing no result, when there is
no CUDA device. fp32 throughout, with TF32 off for convolutions and
matrix products.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "docs", "results", "occ_best_bf16.npz")

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FLOPS_PER_PAIR = 8  # 3 sub, 3 mul, 2 add per voxel-point pair

ROOT_DIMS = (32, 32, 32)  # the ICC grid

# tolerances (see each phase)
D2_ATOL, D2_RTOL = 1e-3, 1e-5
TIE_GAP = 1e-4
POSE_ATOL, CONF_ATOL = 1e-3, 1e-4
LOSS_ATOL = 1e-4


class CheckFailed(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps, warmup=2):
    """Mean time of ``fn`` on the card, by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- phase 1


def min_dist_inputs(seed, B, P, case, device):
    g = np.random.RandomState(seed)
    ip = g.uniform(-2, 34, (B, P, 3)).astype(np.float32)
    valid = g.rand(B, P) > (0.5 if case == "masked" else 0.1)
    if case == "nan":
        ip[:, g.choice(P, P // 5, replace=False), g.randint(3)] = np.nan
    if case == "empty_lane":
        valid[1] = False
    payload = g.randint(0, 1 << 14, (B, P)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (ip, valid, payload))


def min_dist_bound(ip, valid, dims):
    """Least time (ms) on an H100 for one call on these inputs, and what
    bounds it: the larger of the fp32 operations over the fp32 peak and
    the bytes moved once over the memory rate."""
    B, P, _ = ip.shape
    V = int(np.prod(dims))
    n_valid = int((valid & ~torch.isnan(ip).any(-1)).sum())
    ops_s = FLOPS_PER_PAIR * V * n_valid / PEAK_FP32_FLOPS
    bytes_moved = B * P * (3 * 4 + 1 + 4) + B * V * (4 + 4 + 4)
    bytes_s = bytes_moved / PEAK_BYTES_PER_S
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def compare_min_dist(out, ref, ip):
    """Kernel output ``out`` against the plain version's ``ref``."""
    d2, arg, pay = out
    rd2, rarg, rpay = ref
    check(torch.equal(torch.isinf(d2), torch.isinf(rd2)),
          "min_dist: empty voxels differ")
    fin = torch.isfinite(rd2)
    err = (d2[fin] - rd2[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    check(bool((err <= D2_ATOL + D2_RTOL * rd2[fin].abs()).all()),
          f"min_dist: d2 off by {max_err}")
    check(bool((arg[~fin] == -1).all()), "min_dist: winner where none")
    # a different winner is only allowed at a tie: its own d2 must be
    # within TIE_GAP of the best
    diff = (arg != rarg) & fin
    n_diff = int(diff.sum())
    if n_diff:
        b, v = diff.nonzero(as_tuple=True)
        _, Y, Z = ROOT_DIMS
        c = torch.stack([v // (Y * Z), (v // Z) % Y, v % Z], -1).to(ip.dtype)
        p = ip[b, arg[b, v].long()]
        d2_winner = ((c - p) ** 2).sum(-1)
        check(bool(((d2_winner - rd2[b, v]).abs() <= TIE_GAP).all()),
              "min_dist: winners differ away from a tie")
    same = arg == rarg
    check(torch.equal(pay[same], rpay[same]), "min_dist: payloads differ")
    return max_err, n_diff


def phase_kernel_vs_plain(device, small):
    from morefusion_tpu_torch.ops import min_dist as md

    B, P = (8, 2048) if not small else (2, 300)
    big = 16384 if not small else 600
    cases = [("icc", B, P), ("masked", B, P), ("nan", B, P),
             ("empty_lane", B, P), ("ragged", B, P - 48 if not small else 250),
             ("p16384", 2, big)]
    results = []
    max_err = 0.0
    for seed, (case, b, p) in enumerate(cases):
        ip, valid, payload = min_dist_inputs(seed, b, p, case, device)
        out = md.min_dist_voxels(ip, valid, payload, ROOT_DIMS)
        sync(device)
        ref = md.min_dist_voxels_plain(ip, valid, payload, ROOT_DIMS)
        err, n_diff = compare_min_dist(out, ref, ip)
        max_err = max(max_err, err)
        results.append(dict(case=case, B=b, P=p, max_abs_err=err,
                            tie_flips=n_diff))
    emit(dict(phase="kernel_vs_plain", ok=True, cases=results,
              tolerance=dict(d2_atol=D2_ATOL, d2_rtol=D2_RTOL,
                             winner_tie_gap=TIE_GAP)))
    return max_err


# --------------------------------------------------------------- phase 2


def make_frame(seed, H=480, W=640, n_obj=4):
    """A synthetic organized RGB-D frame: a tilted table and ``n_obj``
    ellipsoidal bumps, each its own instance, seen by a 525 px camera."""
    g = np.random.RandomState(seed)
    fx = fy = 525.0
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (1.0 + 0.0003 * (v - cy)).astype(np.float32)
    rgb = np.clip(100 + g.normal(0, 12, (H, W, 3)), 0, 255)
    label = np.zeros((H, W), np.int32)
    for k in range(n_obj):
        uc = (k + 0.5) * W / n_obj + g.uniform(-30, 30) * W / 640
        vc = H / 2.0 + g.uniform(-80, 80) * H / 480
        a, b = g.uniform(35, 70, 2) * W / 640
        rr = ((u - uc) / a) ** 2 + ((v - vc) / b) ** 2
        inside = rr < 1.0
        z0 = g.uniform(0.7, 0.9)
        depth[inside] = z0 - 0.05 * np.sqrt(1.0 - rr[inside])
        label[inside] = k + 1
        color = g.uniform(30, 225, 3)
        rgb[inside] = np.clip(color + g.normal(0, 20, (inside.sum(), 3)),
                              0, 255)
    depth[g.rand(H, W) < 0.02] = np.nan
    pcd = np.stack([(u - cx) * depth / fx, (v - cy) * depth / fy, depth],
                   -1).astype(np.float32)
    return rgb.astype(np.uint8), pcd, label


def serving_model(small, seed):
    from morefusion_tpu_torch import models

    if small:
        torch.manual_seed(seed)
        return models.tiny_singleview3d(21, n_point=64, with_occupancy=True)
    model = models.SingleView3D(n_fg_class=21, n_point=1000,
                                with_occupancy=True)
    model.load_state_dict(models.params_from_jax(
        models.load_jax_npz(CHECKPOINT)), strict=True)
    return model


def phase_serving(device, small, counts):
    from morefusion_tpu_torch.geometry import masks_to_bboxes
    from morefusion_tpu_torch.runtime import PoseEstimationNode
    from morefusion_tpu_torch.runtime.pose_estimation import (
        _crop_instance_device,
    )

    H, W, S = (480, 640, 256) if not small else (120, 160, 64)
    rgb, pcd, label = make_frame(1, H, W)
    instance_to_class = {1: 2, 2: 6, 3: 13, 4: 20}
    pitch_table = {c: 0.006 + 0.0004 * c for c in range(1, 22)}

    def voxel_pitch(voxel_dim, class_id):
        return pitch_table[class_id]

    g = np.random.RandomState(2)
    grids = {i: ((g.rand(32, 32, 32) > 0.8) * 255).astype(np.uint8)
             for i in instance_to_class}
    model = serving_model(small, seed=3)
    n_point = model.n_point
    # the same pixels on both devices: drawn here from each crop's mask
    ids = list(instance_to_class)
    bboxes = np.stack([masks_to_bboxes(label == i).round().astype(int)
                       for i in ids])
    _, pcd_c = _crop_instance_device(
        torch.from_numpy(rgb), torch.from_numpy(pcd),
        torch.from_numpy(label), torch.tensor(ids), torch.from_numpy(bboxes),
        S)
    valid = ~torch.isnan(pcd_c).any(-1).reshape(len(ids), -1).numpy()
    sample_indices = {
        i: g.choice(np.flatnonzero(valid[k]), n_point, replace=False)
        for k, i in enumerate(ids)
    }

    node = PoseEstimationNode(model, voxel_pitch, image_size=S,
                              device=device)
    args = (rgb, pcd, label, instance_to_class, grids)
    for c in counts:
        c.launches = 0
    got = node.estimate(*args, sample_indices=sample_indices)
    launches = {c.__name__: c.launches for c in counts}

    cpu_model = serving_model(small, seed=3)
    cpu_node = PoseEstimationNode(cpu_model, voxel_pitch, image_size=S,
                                  device="cpu")
    want = cpu_node.estimate(*args, sample_indices=sample_indices)
    check(sorted(got) == sorted(want) == sorted(ids),
          f"serving: instances {sorted(got)} vs {sorted(want)}")
    pose_err = conf_err = 0.0
    for i in ids:
        T, Tc = got[i]["T_cad2cam"], want[i]["T_cad2cam"]
        check(T.shape == (4, 4) and np.isfinite(T).all(),
              f"serving: bad pose for instance {i}")
        pose_err = max(pose_err, float(np.abs(T - Tc).max()))
        conf_err = max(conf_err, abs(got[i]["confidence"]
                                     - want[i]["confidence"]))
    check(pose_err <= POSE_ATOL, f"serving: poses off by {pose_err}")
    check(conf_err <= CONF_ATOL, f"serving: confidences off by {conf_err}")

    reps = 20 if not small else 2
    for _ in range(3):
        node.estimate(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        node.estimate(*args)
    sync(device)
    ms = (time.perf_counter() - t0) / reps * 1e3
    emit(dict(phase="serving", ok=True, device=str(device),
              frame=[H, W], instances=len(ids), crop=S, n_point=n_point,
              max_pose_err=pose_err, max_conf_err=conf_err,
              tolerance=dict(pose=POSE_ATOL, conf=CONF_ATOL),
              launches=launches, estimate_ms=ms, frames=reps))


# --------------------------------------------------------------- phase 3


def random_rotation(g):
    q = g.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def make_icc_scene(seed, N, M, V):
    """``N`` spheres and boxes of ``M`` solid points with analytic SDF,
    laid out side by side; their target and no-entry grids at the true
    poses; and the true poses perturbed by about 1 cm and 3 degrees."""
    g = np.random.RandomState(seed)
    points, sdf, poses, init = [], [], [], []
    for i in range(N):
        if i % 2 == 0:
            r = g.uniform(0.03, 0.05)
            p = g.uniform(-r, r, (4 * M, 3))
            p = p[np.linalg.norm(p, axis=1) < r][:M]
            s = r - np.linalg.norm(p, axis=1)
        else:
            h = g.uniform(0.02, 0.05, 3)
            p = g.uniform(-h, h, (M, 3))
            s = np.min(h - np.abs(p), axis=1)
        T = np.eye(4)
        T[:3, :3] = random_rotation(g)
        T[:3, 3] = [0.09 * (i % 4), 0.09 * (i // 4), 0.8]
        points.append(p.astype(np.float32))
        sdf.append(s.astype(np.float32))
        poses.append(T)
        d = np.eye(4)
        d[:3, :3] = np.linalg.qr(np.eye(3) + g.normal(0, 0.05, (3, 3)))[0]
        d[:3, :3] *= np.sign(np.diag(d[:3, :3]))[None]
        d[:3, 3] = g.normal(0, 0.01, 3)
        init.append(d @ T)
    extents = [np.linalg.norm(p, axis=1).max() for p in points]
    pitch = np.array([2.4 * e / V for e in extents], np.float32)
    origin = np.stack([T[:3, 3] - pc * (V / 2.0 - 0.5)
                       for T, pc in zip(poses, pitch)]).astype(np.float32)
    world = [p @ T[:3, :3].T + T[:3, 3] for p, T in zip(points, poses)]

    def occupancy(pts, i):
        idx = np.round((pts - origin[i]) / pitch[i]).astype(int)
        idx = idx[((idx >= 0) & (idx < V)).all(1)]
        grid = np.zeros((V, V, V), np.uint8)
        grid[idx[:, 0], idx[:, 1], idx[:, 2]] = 255
        return grid

    target = np.stack([occupancy(world[i], i) for i in range(N)])
    nontarget = np.stack([
        occupancy(np.concatenate([w for j, w in enumerate(world) if j != i]),
                  i) for i in range(N)])
    return (init, points, sdf, pitch, origin, target, nontarget)


def phase_icc(device, small, counts):
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.ops import min_dist as md

    N, M, V = (8, 2048, 32) if not small else (4, 256, 16)
    iterations = 30
    scene = make_icc_scene(4, N, M, V)

    def refine():
        icc = IterativeCollisionCheck(*scene, voxel_dim=V, max_points=M,
                                      device=device)
        return icc.refine(iterations=iterations)

    # kernel against the plain version, in deterministic mode so that the
    # backward's scatter-adds sum in one order in both runs
    torch.use_deterministic_algorithms(True)
    try:
        T_k, loss_k, n_k = refine()
        with mock.patch.object(md, "min_dist_voxels",
                               md.min_dist_voxels_plain):
            T_p, loss_p, n_p = refine()
    finally:
        torch.use_deterministic_algorithms(False)
    loss_err = float(np.abs(loss_k - loss_p).max())
    check(n_k == n_p, f"icc: n_iter {n_k} (kernel) vs {n_p} (plain)")
    check(loss_err <= LOSS_ATOL, f"icc: loss curves off by {loss_err}")

    # the main path, counted
    for c in counts:
        c.launches = 0
    Ts, losses, n_iter = refine()
    launches = {c.__name__: c.launches for c in counts}
    evaluations = n_iter + (n_iter < iterations)
    check(Ts.shape == (N, 4, 4) and np.isfinite(Ts).all(), "icc: bad poses")
    check(losses.shape == (iterations,) and np.isfinite(losses).all(),
          "icc: bad losses")
    check(min(losses) <= losses[0], "icc: best loss above the first")
    if device.type == "cuda":
        check(launches["min_dist_voxels"] == evaluations,
              f"icc: {launches['min_dist_voxels']} min_dist launches for "
              f"{evaluations} loss evaluations")

    # time refine() alone: the objects (host padding and the upload of
    # their arrays) are built before the clock starts, one per call, so
    # that every call starts from the same poses
    reps = 10 if not small else 1
    refine()
    sync(device)
    t0 = time.perf_counter()
    iccs = [IterativeCollisionCheck(*scene, voxel_dim=V, max_points=M,
                                    device=device) for _ in range(reps)]
    sync(device)
    t1 = time.perf_counter()
    for icc in iccs:
        icc.refine(iterations=iterations)
    sync(device)
    sec = (time.perf_counter() - t1) / reps
    construct_ms = (t1 - t0) / reps * 1e3
    emit(dict(phase="icc", ok=True, device=str(device), objects=N,
              points=M, voxel_dim=V, iterations=iterations, n_iter=n_iter,
              first_loss=float(losses[0]), best_loss=float(min(losses)),
              kernel_vs_plain_loss_err=loss_err, tolerance=LOSS_ATOL,
              launches=launches, construct_ms=construct_ms,
              refine_ms=sec * 1e3, refines_per_s=1.0 / sec))
    return launches["min_dist_voxels"]


# --------------------------------------------------------------- phase 4


def phase_kernel_timing(device, small):
    from morefusion_tpu_torch.ops import min_dist as md

    B, P = (8, 2048) if not small else (2, 300)
    ip, valid, payload = min_dist_inputs(0, B, P, "icc", device)
    bound_ms, bound_by = min_dist_bound(ip, valid, ROOT_DIMS)
    row = dict(phase="kernel_timing", shape=dict(B=B, P=P, dims=ROOT_DIMS),
               bound_ms=bound_ms, bound_by=bound_by)
    if device.type != "cuda":
        row.update(kernel_ms=None, plain_ms=None, library_ms=None,
                   note="times are taken on the card only")
        emit(row)
        return row
    centers = md.voxel_centers(ROOT_DIMS, device)[None].expand(B, -1, -1)
    row.update(
        kernel_ms=cuda_ms(
            lambda: md.min_dist_voxels(ip, valid, payload, ROOT_DIMS), 100),
        plain_ms=cuda_ms(
            lambda: md.min_dist_voxels_plain(ip, valid, payload, ROOT_DIMS),
            5),
        # yardstick only, never called by the port: two PyTorch calls,
        # with no mask and no payload
        library_ms=cuda_ms(lambda: torch.cdist(centers, ip).min(dim=2), 10),
        library_call="torch.cdist(centers, points).min(dim=2) (two calls)",
    )
    emit(row)
    return row


# ------------------------------------------------------------------ main


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cpu: rehearse at a reduced size, no card")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # deterministic cuBLAS, for phase 3's deterministic comparison; must be
    # set before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, ROOT)
    from morefusion_tpu_torch.ops import _build
    from morefusion_tpu_torch.ops import min_dist as md

    device = torch.device(args.device)
    small = device.type == "cpu"
    counts = [md.min_dist_voxels]
    if small:
        torch.set_num_threads(min(8, os.cpu_count() or 1))
        print("cpu rehearsal: no card", flush=True)
    else:
        print(card_line(), flush=True)
        build_s, ptxas = _build.build(ptxas_verbose=True)
        _build.load()
        emit(dict(build_s=build_s, nvcc=" ".join(
            _build.NVCC_FLAGS), ptxas=[
                ln.strip() for ln in ptxas.splitlines() if "Used" in ln]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    max_err = phase_kernel_vs_plain(device, small)
    phase_serving(device, small, counts)
    launches = phase_icc(device, small, counts)
    if not small:
        check(launches > 0, "icc: the min_dist kernel was never launched")
    timing = phase_kernel_timing(device, small)

    kernel = dict(
        name="min_dist", route="cuda",
        source="morefusion_tpu_torch/csrc/min_dist.cu",
        replaces="morefusion_tpu/ops/min_dist_pallas.py:60",
        launches=launches, max_abs_err=max_err, ms=timing["kernel_ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
    )
    if small:
        emit(dict(rehearsal_kernels=[kernel]))
        emit(dict(ok=True, rehearsal="cpu"))
        return 0
    emit(dict(kernels=[kernel]))
    print(card_line(), flush=True)
    emit(dict(ok=True, device=dict(platform="gpu",
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
