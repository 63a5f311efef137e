#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``morefusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu  # rehearsal on the CPU, reduced size

Builds the CUDA kernels from ``morefusion_tpu_torch/csrc`` (``min_dist.cu``
and ``knn.cu``) with ``nvcc``, then runs eight phases, each printing one
JSON line:

1. kernel vs plain: the min-distance kernel against its plain PyTorch
   version at the ICC shapes, at edge cases (masked, NaN and overflowing
   points, an empty lane, all lanes empty, ragged P, a prime P, a grid its
   voxel tile does not divide, exact ties across its point splits) and at
   the train step's shape (16 lanes x 3000 solid CAD points under a pose,
   32^3 voxels): d2 bits, winners and payloads identical in every case;
2. serving: ``PoseEstimationNode.estimate`` with the committed occupancy
   checkpoint at full width on one synthetic 480x640 RGB-D frame with four
   instances, against the same node on the CPU, then timed; then the node
   with ICP (``with_icp=True``, procedural CAD points) on the same frame,
   its knn launches counted (one per ICP iteration) and its frames timed
   (the frame's ellipsoids are no CAD shapes: this checks the wiring, not
   accuracy);
3. ICC: ``IterativeCollisionCheck.refine`` (30 iterations) on eight
   synthetic objects of 2048 points, against the same refine with the
   plain version in deterministic mode (losses and poses identical), then
   timed; its kernel launches are counted;
4. min-distance kernel timing at the ICC and the train step's shapes,
   beside the plain version, one PyTorch yardstick, the card's bound and
   the wrapper's host time a call;
5. knn kernel vs plain: the nearest-neighbour kernel against its plain
   version at the training shape (16 lanes x 500,000 queries x 500 CAD
   points) and at edge cases (one reference, exact ties, ties across the
   kernel's reference tiles, a query count that fills no whole block,
   R = 20,000, one lane, NaN and overflowing distances with none finite),
   indices and the winner's d2 bits identical, with and without the d2
   output;
6. training: the full-width SingleView3D train step (occupancy branch and
   loss, ADD-S, B = 16 crops of 256^2, 1000 points, 32^3 grids) from the
   committed occupancy checkpoint: one step's loss and gradients with the
   kernels against the plain versions in deterministic mode, one step on
   the card against the CPU at B = 2, five timed steps with dropout on and
   their kernel launches counted, and one eval step; the batch holds lanes
   of a symmetric class, where ADD-S runs;
7. knn kernel timing at the training shape, beside the plain version,
   ``torch.cdist`` + ``argmin`` and the card's bound, and at the ICP shape
   (phase 8's first object, with the d2 output) with the wrapper's host
   time;
8. ICP: four procedural objects (4000 CAD points each) seen as the
   camera-facing half of their points under a known pose plus 1 mm of
   noise, each started 6 degrees and 8 mm off: ``ICPRegistration.register``
   (100 iterations at most, voxel 0.01 m) on the card against the same on
   the CPU (poses within ``ICP_POSE_ATOL``, equal iterations), its knn
   launches counted (one per iteration), timed per register by the host
   clock, ADD and ADD-S before and after; then ICC followed by ICP on the
   same objects, and the ADD(-S) AUC of the raw, +icp and +icc+icp poses.

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
import warnings
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "docs", "results", "occ_best_bf16.npz")

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# instruction issue of the CUDA cores: 132 SMs x 128 lanes x 1.98 GHz boost
ISSUE_SLOTS_PER_S = 132 * 128 * 1.98e9
KNN_FLOPS_PER_PAIR = 8  # 3 sub, 3 mul, 2 add per query-reference pair

ROOT_DIMS = (32, 32, 32)  # the ICC grid
TRAIN_B, TRAIN_POSES, TRAIN_CAD = 16, 1000, 500  # the JAX train shape

# tolerances (see each phase)
POSE_ATOL, CONF_ATOL = 1e-3, 1e-4
# training: kernel vs plain in deterministic mode (only the bilinear
# upsampling backward stays atomic); card vs CPU (other summation orders)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL, STEP_GRAD_TOTAL = 1e-4, 1e-6
CPU_LOSS_RTOL = 1e-4
CPU_GRAD_RTOL, CPU_GRAD_TOTAL = 1e-3, 1e-5
# ICP, card against CPU: the same correspondences (the knn kernel equals its
# plain version bit for bit), Kabsch's sums in other orders; the CPU tests
# hold the port to the JAX package within 1e-5
ICP_POSE_ATOL = 1e-4
# sugar box, mustard bottle, mug, foam brick (symmetric: scored by ADD-S)
ICP_CLASSES = (3, 5, 14, 21)


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


def host_ms(fn, reps, warmup=2):
    """Mean host time of one call of ``fn``: its wrapper's work and its
    launches, not the card's work (``reps`` calls stay well inside the
    launch queue, so the host never waits for the card). Where this reaches
    ``cuda_ms``, the host bounds the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


# --------------------------------------------------------------- phase 1


def min_dist_inputs(seed, B, P, case, device):
    g = np.random.RandomState(seed)
    ip = g.uniform(-2, 34, (B, P, 3)).astype(np.float32)
    valid = g.rand(B, P) > (0.5 if case == "masked" else 0.1)
    if case == "nan":
        ip[:, g.choice(P, P // 5, replace=False), g.randint(3)] = np.nan
    if case == "empty_lane":
        valid[1] = False
    if case == "all_masked":
        valid[:] = False
    if case == "split_ties":
        # integer points, the first half repeated as the second: exact ties
        # between points P // 2 apart, in different splits of the kernel
        ip = np.round(ip)
        ip[:, P // 2:] = ip[:, : P - P // 2]
        valid[:, P // 2:] = valid[:, : P - P // 2]
    if case == "overflow":
        # valid points whose d2 overflows to inf: lane 0 holds only such
        # points (no winner anywhere), lane 1 one among finite ones
        ip[0] = g.choice([-3e38, 3e38], (P, 3))
        ip[1, 0] = 3e38
        valid[:2] = True
    payload = g.randint(0, 1 << 14, (B, P)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (ip, valid, payload))


def min_dist_pairs(ip, valid, dims):
    """Voxel-point pairs of one call: every voxel against every valid,
    non-NaN point."""
    return int(np.prod(dims)) * int((valid & ~torch.isnan(ip).any(-1)).sum())


def min_dist_bound(ip, valid, dims):
    """Least time (ms) on an H100 for one call on these inputs, and what
    bounds it: the larger of the fp32 operations over the fp32 peak and
    the bytes moved once over the memory rate. The operations are those of
    the separable sum: for each valid point, a subtraction and a square per
    distinct i, j and k, one add per (i, j), and one add and one min per
    voxel."""
    B, P, _ = ip.shape
    X, Y, Z = dims
    V = X * Y * Z
    n_valid = int((valid & ~torch.isnan(ip).any(-1)).sum())
    ops = n_valid * (2 * V + 2 * (X + Y + Z) + X * Y)
    ops_s = ops / PEAK_FP32_FLOPS
    bytes_moved = B * P * (3 * 4 + 1 + 4) + B * V * (4 + 4 + 4)
    bytes_s = bytes_moved / PEAK_BYTES_PER_S
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def compare_min_dist(out, ref, what):
    """Kernel output ``out`` against the plain version's ``ref``: the same
    d2 bits, winners and payloads in every voxel. Returns the largest d2
    difference (0.0) and the number of voxels that differ (0)."""
    d2, arg, pay = out
    rd2, rarg, rpay = ref
    diff = ((d2.view(torch.int32) != rd2.view(torch.int32))
            | (arg != rarg) | (pay != rpay))
    n_diff = int(diff.sum())
    fin = torch.isfinite(rd2) & torch.isfinite(d2)
    err = (d2[fin] - rd2[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    check(n_diff == 0, f"min_dist {what}: {n_diff} voxels differ "
                       f"(d2 up to {max_err} apart)")
    check(torch.equal(torch.isinf(rd2), rarg == -1)
          and bool((rpay[rarg == -1] == 0).all()),
          f"min_dist {what}: the plain version broke its contract")
    return max_err, n_diff


def train_min_dist_inputs(bank, batch, device):
    """The min-distance kernel's inputs as the train step's occupancy loss
    forms them (``functions/tdf.py``): each lane's solid CAD points from
    the bank under the lane's true pose, in voxel units of its grid, their
    mask, and their SDF quantized to 14 bits as the payload."""
    from morefusion_tpu_torch import functions as F

    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    cid = b["class_id"].long()
    T = F.transformation_matrix(b["quaternion_true"], b["translation_true"])
    moved = F.transform_points(bank.solid_points[cid], T)
    ip = (moved - b["origin"][:, None]) / b["pitch"][:, None, None]
    valid = bank.solid_mask[cid] & ~torch.isnan(ip).any(-1)
    sdf = bank.solid_sdf[cid]
    scale = sdf.amax(-1, keepdim=True).clamp_min(
        torch.finfo(torch.float32).tiny)
    payload = torch.round(sdf / scale * 16383.0).clamp(0, 16383)
    return (torch.nan_to_num(ip).contiguous(), valid.contiguous(),
            payload.to(torch.int32).contiguous())


def phase_kernel_vs_plain(device, small, train_inputs):
    from morefusion_tpu_torch.ops import min_dist as md

    B, P = (8, 2048) if not small else (2, 300)
    big = 16384 if not small else 600
    odd = (30, 17, 33) if not small else (9, 5, 11)  # no voxel tile divides it
    cases = [("icc", B, P, ROOT_DIMS), ("masked", B, P, ROOT_DIMS),
             ("nan", B, P, ROOT_DIMS), ("empty_lane", B, P, ROOT_DIMS),
             ("ragged", B, P - 48 if not small else 250, ROOT_DIMS),
             ("p16384", 2, big, ROOT_DIMS), ("ragged_grid", B, P, odd),
             ("prime_p", 3, 1999 if not small else 131, ROOT_DIMS),
             ("split_ties", 4, 4096 if not small else 400, ROOT_DIMS),
             ("overflow", 3, 700 if not small else 70, ROOT_DIMS),
             ("all_masked", 2, P, ROOT_DIMS), ("one_point", 2, 1, odd),
             ("train", None, None, ROOT_DIMS)]
    results = []
    max_err = 0.0
    for seed, (case, b, p, dims) in enumerate(cases):
        if case == "train":
            ip, valid, payload = train_inputs
            b, p = ip.shape[:2]
        else:
            ip, valid, payload = min_dist_inputs(seed, b, p, case, device)
        out = md.min_dist_voxels(ip, valid, payload, dims)
        sync(device)
        ref = md.min_dist_voxels_plain(ip, valid, payload, dims)
        err, n_diff = compare_min_dist(out, ref, case)
        if case == "split_ties":
            check(bool((ref[1] < p - p // 2).all()),
                  "min_dist split_ties: a tie did not go to the lowest index")
        if case == "overflow":
            check(bool((ref[1][0] == -1).all()),
                  "min_dist overflow: an overflowing point won")
        max_err = max(max_err, err)
        results.append(dict(case=case, B=b, P=p, dims=list(dims),
                            max_abs_err=err, voxels_differing=n_diff))
    emit(dict(phase="kernel_vs_plain", ok=True, cases=results,
              tolerance="identical d2 bits, winners and payloads"))
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
    from morefusion_tpu_torch.datasets import ProceduralModels
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

    # the node with ICP: one frame counted, then frames timed
    icp_node = PoseEstimationNode(model, voxel_pitch, image_size=S,
                                  device=device, with_icp=True,
                                  cad_points=ProceduralModels().get_pcd)
    for c in counts:
        c.launches = 0
    refined = icp_node.estimate(*args, sample_indices=sample_indices)
    icp_launches = {c.__name__: c.launches for c in counts}
    icp_iterations = dict(icp_node.last_icp_iterations)
    check(sorted(refined) == sorted(ids)
          and all(np.isfinite(refined[i]["T_cad2cam"]).all() for i in ids),
          "serving with ICP: bad poses")
    check(sorted(icp_iterations) == sorted(ids),
          f"serving with ICP: refined {sorted(icp_iterations)}")
    if device.type == "cuda":
        check(icp_launches["nn_indices"] == sum(icp_iterations.values()),
              f"serving with ICP: {icp_launches['nn_indices']} knn launches "
              f"for {sum(icp_iterations.values())} ICP iterations")
    icp_reps = 5 if not small else 1
    sync(device)
    t0 = time.perf_counter()
    for _ in range(icp_reps):
        icp_node.estimate(*args)
    sync(device)
    icp_ms = (time.perf_counter() - t0) / icp_reps * 1e3
    emit(dict(phase="serving", ok=True, device=str(device),
              frame=[H, W], instances=len(ids), crop=S, n_point=n_point,
              max_pose_err=pose_err, max_conf_err=conf_err,
              tolerance=dict(pose=POSE_ATOL, conf=CONF_ATOL),
              launches=launches, estimate_ms=ms, frames=reps,
              with_icp=dict(icp_iterations=icp_iterations,
                            launches=icp_launches, estimate_ms=icp_ms,
                            frames=icp_reps)))
    return icp_launches["nn_indices"]


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


def occupancy_grid(points, origin, pitch, V):
    """``(V, V, V)`` uint8 grid, 255 where a point falls."""
    idx = np.round((points - origin) / pitch).astype(int)
    idx = idx[((idx >= 0) & (idx < V)).all(1)]
    grid = np.zeros((V, V, V), np.uint8)
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = 255
    return grid


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
    target = np.stack([occupancy_grid(world[i], origin[i], pitch[i], V)
                       for i in range(N)])
    nontarget = np.stack([
        occupancy_grid(
            np.concatenate([w for j, w in enumerate(world) if j != i]),
            origin[i], pitch[i], V) for i in range(N)])
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
    # the kernel's outputs equal the plain version's bit for bit, so the
    # two refines are the same computation
    loss_err = float(np.abs(loss_k - loss_p).max())
    pose_err = float(np.abs(T_k - T_p).max())
    check(n_k == n_p, f"icc: n_iter {n_k} (kernel) vs {n_p} (plain)")
    check(loss_err == 0.0 and pose_err == 0.0,
          f"icc: loss curves {loss_err} and poses {pose_err} apart")

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
              kernel_vs_plain_loss_err=loss_err,
              kernel_vs_plain_pose_err=pose_err, tolerance="identical",
              launches=launches, construct_ms=construct_ms,
              refine_ms=sec * 1e3, refines_per_s=1.0 / sec))
    return launches["min_dist_voxels"]


# --------------------------------------------------------------- phase 4


def min_dist_timing(device, ip, valid, payload, reps):
    """One shape's row: the bound and, on the card, the kernel's, the plain
    version's and the yardstick's times, and the wrapper's host time."""
    from morefusion_tpu_torch.ops import min_dist as md

    B, P, _ = ip.shape
    bound_ms, bound_by = min_dist_bound(ip, valid, ROOT_DIMS)
    pairs = min_dist_pairs(ip, valid, ROOT_DIMS)
    row = dict(shape=dict(B=B, P=P, dims=ROOT_DIMS), pairs=pairs,
               bound_ms=bound_ms, bound_by=bound_by)
    if device.type != "cuda":
        row.update(kernel_ms=None, plain_ms=None, library_ms=None,
                   slots_per_pair=None, host_ms=None)
        return row
    centers = md.voxel_centers(ROOT_DIMS, device)[None].expand(B, -1, -1)

    def kernel():
        return md.min_dist_voxels(ip, valid, payload, ROOT_DIMS)

    kernel_ms = cuda_ms(kernel, reps)
    row.update(
        kernel_ms=kernel_ms,
        host_ms=host_ms(kernel, reps),
        slots_per_pair=kernel_ms * 1e-3 * ISSUE_SLOTS_PER_S / pairs,
        plain_ms=cuda_ms(
            lambda: md.min_dist_voxels_plain(ip, valid, payload, ROOT_DIMS),
            5),
        # yardstick only, never called by the port: two PyTorch calls,
        # with no mask and no payload
        library_ms=cuda_ms(lambda: torch.cdist(centers, ip).min(dim=2), 5),
    )
    return row


def phase_kernel_timing(device, small, train_inputs):
    """The min-distance kernel at the ICC shape and at the train step's."""
    B, P = (8, 2048) if not small else (2, 300)
    icc = min_dist_timing(
        device, *min_dist_inputs(0, B, P, "icc", device), 100)
    train = min_dist_timing(device, *train_inputs, 50)
    row = dict(phase="kernel_timing", **icc, train=train,
               library_call="torch.cdist(centers, points).min(dim=2) "
                            "(two calls)")
    if device.type != "cuda":
        row["note"] = "times are taken on the card only"
    emit(row)
    return row


# --------------------------------------------------------------- phase 5


def knn_inputs(seed, B, R, Q, case, device):
    """``ref (B, R, 3)`` and ``query (B, Q, 3)`` on ``device``. ``train``:
    each lane's R CAD-like points at 0.8 m from the camera, the queries the
    same points under Q / R predicted poses about 2 cm and 10 degrees off,
    as ADD-S sees them in training."""
    g = np.random.RandomState(seed)
    ref = g.uniform(-0.1, 0.1, (B, R, 3)) + [0.0, 0.0, 0.8]
    if case.startswith("ties"):
        # integer points, each twice (R // 2 apart): exact ties that the
        # lowest index wins
        ref = g.randint(-4, 5, (B, R, 3)).astype(np.float64)
        ref[:, R // 2:] = ref[:, : R - R // 2]
    ref_t = torch.from_numpy(ref.astype(np.float32)).to(device)
    if case == "nan_overflow":
        # lane 0: reference 0 gives NaN, every other one overflows, so no
        # distance is finite (index 0, d2 +inf)
        ref_t[0, 0, 0] = float("nan")
        ref_t[0, 1:, 2] = 3e38
    if case == "train":
        M = Q // R
        rot = np.stack([[random_rotation_near(g, 0.1) for _ in range(M)]
                        for _ in range(B)])  # (B, M, 3, 3)
        shift = g.normal(0, 0.02, (B, M, 3))
        rot_t = torch.from_numpy(rot.astype(np.float32)).to(device)
        center = ref_t.mean(1, keepdim=True)[:, None]  # (B, 1, 1, 3)
        query_t = (torch.einsum("bmij,bmnj->bmni", rot_t,
                                ref_t[:, None] - center) + center
                   + torch.from_numpy(shift.astype(np.float32)).to(
                       device)[:, :, None]).reshape(B, Q, 3).contiguous()
    else:
        ties = case.startswith("ties")
        lo, hi = (-5, 6) if ties else (-0.12, 0.12)
        query = g.uniform(lo, hi, (B, Q, 3)) + (0.0 if ties else [0.0, 0.0, 0.8])
        if ties:
            query = np.round(query)
        query_t = torch.from_numpy(query.astype(np.float32)).to(device)
    return ref_t, query_t


def random_rotation_near(g, scale):
    a = np.linalg.qr(np.eye(3) + g.normal(0, scale, (3, 3)))[0]
    return a * np.sign(np.diag(a))[None]


def knn_bound(ref, query, with_d2=False):
    """Least time (ms) on an H100 for one knn call on these inputs: every
    query-reference pair at 8 fp32 flops, against reading the inputs and
    writing the indices (and the winners' d2) once."""
    B, R, _ = ref.shape
    Q = query.shape[1]
    ops_s = KNN_FLOPS_PER_PAIR * B * Q * R / PEAK_FP32_FLOPS
    out_bytes = B * Q * (8 if with_d2 else 4)
    bytes_s = (B * (Q + R) * 3 * 4 + out_bytes) / PEAK_BYTES_PER_S
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def chosen_d2(ref, query, idx):
    """Squared distance of each query to the reference point ``idx`` picks."""
    p = torch.gather(ref, 1, idx.long()[..., None].expand(-1, -1, 3))
    return ((query - p) ** 2).sum(-1)


def finite_max_abs(a, b):
    diff = (a - b).abs()
    diff = diff[torch.isfinite(diff)]
    return float(diff.max()) if diff.numel() else 0.0


def phase_knn_vs_plain(device, small):
    from morefusion_tpu_torch.ops import knn

    B, M, N = ((TRAIN_B, TRAIN_POSES, TRAIN_CAD) if not small
               else (2, 20, 50))
    # the kernel takes kThreads x kQ = 1024 queries a block and kTile = 2048
    # references a shared-memory tile, in sub-tiles of kSub (csrc/knn.cu)
    cases = [("train", B, N, M * N), ("one_ref", 2, 1, 4096),
             ("ties", 2, 64, 4096), ("ragged", 3, N, 50 * N + 17),
             ("above_tpu_cap", 1, 20000 if not small else 700, 3000),
             ("one_lane", 1, N, 10 * N), ("ragged_block", 2, 37, 3 * 1024 + 1),
             ("ties_across_tiles", 2, 5000 if not small else 300, 2000),
             ("nan_overflow", 2, 40, 1000)]
    results = []
    max_err = 0.0
    for seed, (case, b, r, q) in enumerate(cases):
        ref, query = knn_inputs(100 + seed, b, r, q, case, device)
        got = knn.nn_indices(ref, query)  # ADD-S's call: no d2 written
        got_d2, d2 = knn.nn_indices(ref, query, return_d2=True)  # ICP's
        sync(device)
        want, want_d2 = knn.nn_indices_plain(ref, query, return_d2=True)
        n_diff = int((got != want).sum()) + int((got_d2 != want).sum())
        d2_diff = int((d2.view(torch.int32) != want_d2.view(torch.int32))
                      .sum())
        err = finite_max_abs(chosen_d2(ref, query, got),
                             chosen_d2(ref, query, want))
        check(n_diff == 0, f"knn {case}: {n_diff} indices differ "
                           f"(chosen d2 up to {err} apart)")
        check(d2_diff == 0, f"knn {case}: {d2_diff} winners' d2 differ "
                            f"(up to {finite_max_abs(d2, want_d2)} apart)")
        if case.startswith("ties"):
            check(bool((got < r - r // 2).all()),
                  "knn ties: a tie did not go to the lowest index")
        if case == "nan_overflow":
            check(bool((got[0] == 0).all() and torch.isposinf(d2[0]).all()),
                  "knn nan_overflow: no finite distance, yet not index 0 "
                  "and d2 +inf")
        max_err = max(max_err, err)
        results.append(dict(case=case, B=b, R=r, Q=q, index_mismatches=n_diff,
                            d2_mismatches=d2_diff, max_abs_err=err))
    emit(dict(phase="knn_vs_plain", ok=True, cases=results,
              tolerance="identical indices and d2 bits"))
    return max_err


# --------------------------------------------------------------- phase 6


def make_train_batch(B, S=256, V=32, seed=0):
    """The JAX package's synthetic train batch (``make_batch`` of
    ``examples/profile_train.py``, copied: this script imports nothing of
    that package)."""
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 255, (B, S, S, 3)).astype(np.float32)
    pcd = rng.uniform(-0.2, 0.2, (B, S, S, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    hole = rng.rand(B, S, S) < 0.35
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


def loss_and_grads(model, loss_fn, batch, train, seed=0):
    """One step's metrics and gradients, without the optimizer, and the
    pose each lane's occupancy loss took (its highest confidence)."""
    from morefusion_tpu_torch.training import trainer

    device = next(model.parameters()).device
    model.zero_grad(set_to_none=True)
    sample_gen, dropout_gen = trainer.step_generators(seed, 0, device)
    seen = []
    hook = model.register_forward_hook(
        lambda mod, args, out: seen.append(out[2].detach()))
    try:
        loss, metrics = loss_fn(batch, True, train=train,
                                sample_generator=sample_gen,
                                dropout_generator=dropout_gen)
    finally:
        hook.remove()
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    best = seen[0].argmax(dim=1).tolist()
    return {k: float(v.detach()) for k, v in metrics.items()}, grads, best


def compare_steps(got, want, loss_rtol, grad_rtol, grad_total, what):
    """Metrics within ``loss_rtol``; each parameter's gradient within
    ``grad_rtol`` of its own norm plus ``grad_total`` of the whole
    gradient's norm. Returns the worst errors."""
    (m1, g1, best1), (m2, g2, best2) = got, want
    # the occupancy loss takes each lane's best-confidence pose: a near-tie
    # that the two runs break differently compares two other poses
    check(best1 == best2, f"{what}: best poses {best1} vs {best2}")
    loss_err = max(abs(m1[k] - m2[k]) / max(abs(m2[k]), 1e-12) for k in m2)
    check(loss_err <= loss_rtol, f"{what}: losses {m1} vs {m2}")
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in g2.values())))
    worst_rel = worst_ratio = 0.0
    for name, g in g2.items():
        err = float((g1[name].to(g.device) - g).norm())
        norm = float(g.norm())
        bound = grad_rtol * norm + grad_total * total
        worst_rel = max(worst_rel, err / max(norm, 1e-30))
        worst_ratio = max(worst_ratio, err / bound)
        check(err <= bound, f"{what}: gradient of {name} off by {err} "
                            f"(norm {norm}, whole gradient {total})")
    return dict(loss_rel_err=loss_err, grad_max_rel_err=worst_rel,
                grad_max_err_over_tolerance=worst_ratio, best_poses=best1)


def train_setup(device, small):
    """The procedural CAD models, their bank on ``device`` (500 points and
    up to 3000 solid points per class), the seconds the bank took to
    build, and the train batch. ADD-S, and so the knn kernel, enters the
    loss only in lanes of a symmetric class; the batch must hold one."""
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.training import trainer

    B, S = (TRAIN_B, 256) if not small else (2, 64)
    t0 = time.perf_counter()
    models = ProceduralModels()
    bank = trainer.CadPointBank.build(models, 21, device=device)
    bank_s = time.perf_counter() - t0
    batch = make_train_batch(B, S)
    symmetric = bank.symmetric.cpu().numpy()
    if not symmetric[batch["class_id"]].any():
        # the rehearsal's two lanes draw none: give the last lane one
        batch["class_id"][-1] = np.flatnonzero(symmetric)[0]
    return models, bank, bank_s, batch


def phase_train(device, small, counts, setup):
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md
    from morefusion_tpu_torch.training import trainer

    models, bank, bank_s, batch = setup
    B, S = batch["rgb"].shape[:2]
    symmetric_lanes = int(
        bank.symmetric.cpu().numpy()[batch["class_id"]].sum())
    check(symmetric_lanes >= 1, "train: no lane of a symmetric class")
    model = serving_model(small, seed=5).to(device)

    # (a) kernels against plain versions: same device, same generators, so
    # the same samples and dropout masks; deterministic mode makes the
    # scatter-adds sum in one order (the bilinear upsampling backward has
    # no deterministic CUDA version and stays atomic: warn_only)
    loss_fn = trainer.make_loss_fn(model, bank)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            kernel = loss_and_grads(model, loss_fn, batch, train=True)
            with mock.patch.object(md, "min_dist_voxels",
                                   md.min_dist_voxels_plain), \
                    mock.patch.object(knn, "nn_indices",
                                      knn.nn_indices_plain):
                plain = loss_and_grads(model, loss_fn, batch, train=True)
    finally:
        torch.use_deterministic_algorithms(False)
    vs_plain = compare_steps(kernel, plain, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
                             STEP_GRAD_TOTAL, "train kernel vs plain")
    del kernel, plain

    # (b) the card against the CPU at B = 2, dropout off, same samples
    b2 = make_train_batch(2, S, seed=1)
    mask = ~np.isnan(b2["pcd"]).any(-1).reshape(2, -1)
    g = np.random.RandomState(6)
    b2["sample_indices"] = np.stack([
        g.choice(np.flatnonzero(m), model.n_point, replace=False)
        for m in mask]).astype(np.int64)
    on_card = loss_and_grads(model, loss_fn, b2, train=False)
    cpu_model = serving_model(small, seed=5)
    cpu_bank = trainer.CadPointBank.build(models, 21, device="cpu")
    on_cpu = loss_and_grads(cpu_model,
                            trainer.make_loss_fn(cpu_model, cpu_bank),
                            b2, train=False)
    vs_cpu = compare_steps(on_card, on_cpu, CPU_LOSS_RTOL, CPU_GRAD_RTOL,
                           CPU_GRAD_TOTAL, "train card vs cpu")
    del on_card, on_cpu, cpu_model, cpu_bank

    # (c) the main path: five steps with dropout on, counted and timed
    state = trainer.create_train_state(model)
    step = trainer.make_train_step(model, bank)
    n_steps = 5
    for c in counts:
        c.launches = 0
    step_ms, losses = [], []
    for _ in range(n_steps):
        sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, True, seed=0)
        loss = float(metrics["loss"])  # reads back: the step has ended
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
        check(np.isfinite(loss), f"train: loss {loss} at step {state.step}")
    launches = {c.__name__: c.launches for c in counts}
    if device.type == "cuda":
        for name in ("min_dist_voxels", "nn_indices"):
            check(launches[name] >= n_steps,
                  f"train: {launches[name]} {name} launches in {n_steps} "
                  f"steps")

    # (d) one eval step
    out = trainer.make_eval_step(model, bank)(batch)
    for k in ("add", "add_s", "add_or_add_s"):
        check(out[k].shape == (B,) and bool(torch.isfinite(out[k]).all()),
              f"eval: bad {k}")
    check(bool((out["add_s"] <= out["add"] + 1e-6).all()),
          "eval: ADD-S above ADD")
    emit(dict(phase="train", ok=True, device=str(device), batch=B, crop=S,
              n_point=model.n_point, voxel_dim=model.voxel_dim,
              symmetric_lanes=symmetric_lanes, bank_build_s=bank_s, kernel_vs_plain=vs_plain,
              card_vs_cpu=vs_cpu,
              tolerance=dict(kernel_vs_plain=dict(
                  loss_rtol=STEP_LOSS_RTOL, grad_rtol=STEP_GRAD_RTOL,
                  grad_of_whole=STEP_GRAD_TOTAL),
                  card_vs_cpu=dict(loss_rtol=CPU_LOSS_RTOL,
                                   grad_rtol=CPU_GRAD_RTOL,
                                   grad_of_whole=CPU_GRAD_TOTAL,
                                   best_poses="equal")),
              steps=n_steps, losses=losses,
              step_ms=step_ms, median_step_ms=float(np.median(step_ms)),
              launches=launches,
              launches_per_step={k: v / n_steps for k, v in launches.items()},
              eval_add=[float(x) for x in out["add_or_add_s"]]))
    return launches


# --------------------------------------------------------------- phase 7


def knn_icp_timing(device, ref, query):
    """The knn kernel at ICP's shape, with the d2 output ICP reads: the
    bound, and on the card the kernel's, the plain version's and the
    yardstick's times and the wrapper's host time a call."""
    from morefusion_tpu_torch.ops import knn

    B, R, _ = ref.shape
    Q = query.shape[1]
    bound_ms, bound_by = knn_bound(ref, query, with_d2=True)
    row = dict(shape=dict(B=B, Q=Q, R=R), pairs=B * Q * R,
               bound_ms=bound_ms, bound_by=bound_by)
    if device.type != "cuda":
        row.update(kernel_ms=None, host_ms=None, plain_ms=None,
                   library_ms=None)
        return row

    def kernel():
        return knn.nn_indices(ref, query, return_d2=True)

    row.update(
        kernel_ms=cuda_ms(kernel, 200),
        host_ms=host_ms(kernel, 200),
        plain_ms=cuda_ms(
            lambda: knn.nn_indices_plain(ref, query, return_d2=True), 50),
        # yardstick only, never called by the port: distances, not squared
        library_ms=cuda_ms(lambda: torch.cdist(query, ref).min(dim=2), 50),
        library_call="torch.cdist(query, ref).min(dim=2) (two calls)",
    )
    return row


def phase_knn_timing(device, small, icp_clouds):
    from morefusion_tpu_torch.ops import knn

    B, M, N = ((TRAIN_B, TRAIN_POSES, TRAIN_CAD) if not small
               else (2, 20, 50))
    ref, query = knn_inputs(100, B, N, M * N, "train", device)
    bound_ms, bound_by = knn_bound(ref, query)
    pairs = B * M * N * N
    row = dict(phase="knn_timing", shape=dict(B=B, Q=M * N, R=N),
               pairs=pairs, bound_ms=bound_ms, bound_by=bound_by,
               icp_shape=knn_icp_timing(device, *icp_clouds))
    if device.type != "cuda":
        row.update(kernel_ms=None, plain_ms=None, library_ms=None,
                   slots_per_pair=None,
                   note="times are taken on the card only")
        emit(row)
        return row
    chunk = 62500  # (16, 62500, 500) distances: 2 GB a call

    def library():
        for base in range(0, M * N, chunk):
            torch.cdist(query[:, base:base + chunk], ref).argmin(dim=2)

    kernel_ms = cuda_ms(lambda: knn.nn_indices(ref, query), 20)
    row.update(
        kernel_ms=kernel_ms,
        slots_per_pair=kernel_ms * 1e-3 * ISSUE_SLOTS_PER_S / pairs,
        plain_ms=cuda_ms(lambda: knn.nn_indices_plain(ref, query), 2, 1),
        # yardstick only, never called by the port
        library_ms=cuda_ms(library, 3, 1),
        library_call=f"torch.cdist(query, ref).argmin(dim=2), "
                     f"{-(-M * N // chunk)} chunks of {chunk} queries",
    )
    emit(row)
    return row


# --------------------------------------------------------------- phase 8


def rotation_about(axis, degrees):
    """Rotation matrix by ``degrees`` about the unit vector ``axis``."""
    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    a = np.radians(degrees)
    return np.eye(3) + np.sin(a) * K + (1.0 - np.cos(a)) * K @ K


def make_icp_scene(seed, small):
    """Four procedural objects side by side 0.8 m from the camera: each
    class's CAD points (4000; 1000 in the rehearsal), the camera-facing half
    of them under the true pose (the nearer half in depth) plus 1 mm of
    Gaussian noise as the observed depth points, the true pose, and the
    true pose turned 6 degrees about a random axis and moved 8 mm in a
    random direction as the start."""
    from morefusion_tpu_torch.datasets import ProceduralModels

    g = np.random.RandomState(seed)
    models = ProceduralModels()
    scene = []
    for k, class_id in enumerate(ICP_CLASSES):
        cad = models.get_pcd(class_id)[: 1000 if small else None]
        T = np.eye(4)
        T[:3, :3] = random_rotation(g)
        T[:3, 3] = [0.2 * k - 0.3, g.uniform(-0.03, 0.03), 0.8]
        world = cad @ T[:3, :3].T + T[:3, 3]
        near = world[:, 2] < np.median(world[:, 2])
        depth = world[near] + g.normal(0, 0.001, (int(near.sum()), 3))
        axis = g.normal(size=3)
        axis /= np.linalg.norm(axis)
        shift = g.normal(size=3)
        P = np.eye(4)
        P[:3, :3] = rotation_about(axis, 6.0)
        P[:3, 3] = 0.008 * shift / np.linalg.norm(shift)
        scene.append(dict(class_id=class_id, cad=cad, depth=depth, T_true=T,
                          T_init=T @ P))
    return scene


def icp_clouds(scene, device, voxel_size=0.01):
    """The knn call of the first ICP iteration on the scene's first object:
    ``ref`` its down-sampled CAD points, ``query`` its down-sampled depth
    points moved by the inverted start pose, each ``(1, n, 3)``."""
    from morefusion_tpu_torch.geometry import voxel_down_sample

    obj = scene[0]
    cad = voxel_down_sample(obj["cad"], voxel_size).astype(np.float32)
    depth = voxel_down_sample(obj["depth"], voxel_size)
    T = np.linalg.inv(obj["T_init"])
    moved = (depth @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return tuple(torch.from_numpy(a[None]).to(device) for a in (cad, moved))


def add_errors(scene, poses):
    """Each object's ADD and ADD-S (metres) of ``poses`` against the true
    poses, over all its CAD points, and the score the YCB-Video protocol
    takes: ADD-S for a symmetric class, ADD otherwise."""
    from morefusion_tpu_torch import metrics
    from morefusion_tpu_torch.datasets.ycb_video.class_names import (
        class_ids_symmetric,
    )

    add, add_s = metrics.average_distance(
        [obj["cad"].astype(np.float64) for obj in scene],
        [obj["T_true"] for obj in scene], list(poses))
    score = np.where(
        np.isin([obj["class_id"] for obj in scene], class_ids_symmetric),
        add_s, add)
    return dict(add=add.tolist(), add_s=add_s.tolist(),
                add_or_add_s=score.tolist())


def icc_for_scene(scene, device, V=32):
    """``IterativeCollisionCheck`` on the scene from the start poses: each
    object's solid points and SDF from the procedural bank, its grid
    centred on its start pose, its own observed points as the target grid
    and the other objects' as the no-entry grid."""
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.datasets import ProceduralModels

    models = ProceduralModels()
    solids = [models.get_solid_voxel_grid(obj["class_id"]) for obj in scene]
    pitch = np.array([2.4 * np.linalg.norm(obj["cad"], axis=1).max() / V
                      for obj in scene], np.float32)
    origin = np.stack([obj["T_init"][:3, 3] - p * (V / 2.0 - 0.5)
                       for obj, p in zip(scene, pitch)]).astype(np.float32)
    target = np.stack([occupancy_grid(obj["depth"], origin[i], pitch[i], V)
                       for i, obj in enumerate(scene)])
    nontarget = np.stack([
        occupancy_grid(np.concatenate(
            [o["depth"] for j, o in enumerate(scene) if j != i]),
            origin[i], pitch[i], V) for i in range(len(scene))])
    return IterativeCollisionCheck(
        [obj["T_init"] for obj in scene],
        [s.points.astype(np.float32) for s in solids],
        [s.inside_distance.astype(np.float32) for s in solids],
        pitch, origin, target, nontarget, voxel_dim=V, max_points=2048,
        device=device)


def phase_icp(device, small, counts, scene):
    from morefusion_tpu_torch import metrics
    from morefusion_tpu_torch.contrib import ICPRegistration
    from morefusion_tpu_torch.contrib import icp

    def register(T_start, dev):
        out = []
        for obj, T in zip(scene, T_start):
            reg = ICPRegistration(obj["depth"], obj["cad"], T, device=dev)
            t0 = time.perf_counter()
            T_icp = reg.register()
            out.append((T_icp, reg.last_n_iterations,
                        (time.perf_counter() - t0) * 1e3))
        return out

    T_init = [obj["T_init"] for obj in scene]
    register(T_init, device)  # warm-up
    # the main path, counted
    for c in counts:
        c.launches = 0
    got = register(T_init, device)
    launches = {c.__name__: c.launches for c in counts}
    n_iter = [n for _, n, _ in got]
    if device.type == "cuda":
        check(launches["nn_indices"] == sum(n_iter),
              f"icp: {launches['nn_indices']} knn launches for "
              f"{sum(n_iter)} iterations")
    check(all(np.isfinite(T).all() for T, _, _ in got), "icp: bad poses")

    # the card against the CPU, from the same start poses
    want = register(T_init, "cpu")
    pose_err = max(float(np.abs(a[0] - b[0]).max())
                   for a, b in zip(got, want))
    check([n for _, n, _ in want] == n_iter,
          f"icp: iterations {n_iter} (card) vs "
          f"{[n for _, n, _ in want]} (cpu)")
    check(pose_err <= ICP_POSE_ATOL, f"icp: card and cpu poses "
                                     f"{pose_err} apart")

    # what the gated loop's host read of the RMSE costs: the same
    # iterations without it (a fixed count queued back to back)
    cad, depth = (a[0] for a in icp_clouds(scene, device))
    T0 = torch.eye(4, device=device)
    _, n0 = icp.icp_point_to_point_gated(depth, cad, T0)
    timing = {}
    for name, fn in (
            ("gated", lambda: icp.icp_point_to_point_gated(depth, cad, T0)),
            ("fixed", lambda: icp.icp_point_to_point(
                depth, cad, T0, iterations=n0))):
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        sync(device)
        timing[name] = (time.perf_counter() - t0) / 3 * 1e3 / n0

    # ICC, then ICP from its poses
    icc = icc_for_scene(scene, device)
    T_icc, icc_losses, icc_n = icc.refine(iterations=30)
    got_icc = register(T_icc, device)
    errors = dict(
        raw=add_errors(scene, T_init),
        icp=add_errors(scene, [T for T, _, _ in got]),
        icc=add_errors(scene, T_icc),
        icc_icp=add_errors(scene, [T for T, _, _ in got_icc]))
    auc = {k: float(metrics.ycb_video_add_auc(np.asarray(v["add_or_add_s"])))
           for k, v in errors.items()}
    mean_add = {k: float(np.mean(v["add"])) for k, v in errors.items()}
    check(mean_add["icp"] < mean_add["raw"],
          f"icp: mean ADD {mean_add['icp']} after, {mean_add['raw']} before")
    register_ms = [ms for _, _, ms in got]
    emit(dict(phase="icp", ok=True, device=str(device),
              classes=list(ICP_CLASSES),
              points=dict(cad=[len(o["cad"]) for o in scene],
                          depth=[len(o["depth"]) for o in scene]),
              n_iterations=n_iter, launches=launches,
              card_vs_cpu_pose_err=pose_err,
              tolerance=dict(pose=ICP_POSE_ATOL, n_iterations="equal"),
              register_ms=register_ms,
              ms_per_iteration=sum(register_ms) / sum(n_iter),
              first_object_ms_per_iteration=timing,
              icc=dict(n_iter=icc_n, first_loss=float(icc_losses[0]),
                       best_loss=float(min(icc_losses))),
              icc_icp_n_iterations=[n for _, n, _ in got_icc],
              errors=errors, mean_add=mean_add, add_auc=auc))
    return launches["nn_indices"]


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
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md

    device = torch.device(args.device)
    small = device.type == "cpu"
    counts = [md.min_dist_voxels, knn.nn_indices]
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

    setup = train_setup(device, small)
    train_inputs = train_min_dist_inputs(setup[1], setup[3], device)
    icp_scene = make_icp_scene(9, small)
    max_err = phase_kernel_vs_plain(device, small, train_inputs)
    serving_icp_launches = phase_serving(device, small, counts)
    icc_launches = phase_icc(device, small, counts)
    if not small:
        check(icc_launches > 0, "icc: the min_dist kernel was never launched")
    timing = phase_kernel_timing(device, small, train_inputs)
    del train_inputs
    knn_err = phase_knn_vs_plain(device, small)
    train_launches = phase_train(device, small, counts, setup)
    knn_timing = phase_knn_timing(device, small,
                                  icp_clouds(icp_scene, device))
    icp_launches = phase_icp(device, small, counts, icp_scene)
    if not small:
        check(icp_launches > 0, "icp: the knn kernel was never launched")

    kernels = [dict(
        name="min_dist", route="cuda",
        source="morefusion_tpu_torch/csrc/min_dist.cu",
        replaces="morefusion_tpu/ops/min_dist_pallas.py:60",
        launches=icc_launches + train_launches["min_dist_voxels"],
        launches_by_path=dict(icc_refine=icc_launches,
                              train_5_steps=train_launches["min_dist_voxels"]),
        max_abs_err=max_err, ms=timing["kernel_ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        slots_per_pair=timing["slots_per_pair"],
        host_ms=timing["host_ms"],
        train_shape={k: timing["train"][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "slots_per_pair", "host_ms")},
    ), dict(
        name="knn", route="cuda",
        source="morefusion_tpu_torch/csrc/knn.cu",
        replaces="morefusion_tpu/ops/knn_pallas.py:36",
        launches=(train_launches["nn_indices"] + icp_launches
                  + serving_icp_launches),
        launches_by_path=dict(train_5_steps=train_launches["nn_indices"],
                              icp=icp_launches,
                              serving_icp=serving_icp_launches),
        max_abs_err=knn_err, ms=knn_timing["kernel_ms"],
        plain_ms=knn_timing["plain_ms"], bound_ms=knn_timing["bound_ms"],
        bound_by=knn_timing["bound_by"], library_ms=knn_timing["library_ms"],
        slots_per_pair=knn_timing["slots_per_pair"],
        icp_shape={k: knn_timing["icp_shape"][k] for k in (
            "shape", "kernel_ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
    )]
    if small:
        emit(dict(rehearsal_kernels=kernels))
        emit(dict(ok=True, rehearsal="cpu"))
        return 0
    emit(dict(kernels=kernels))
    print(card_line(), flush=True)
    emit(dict(ok=True, device=dict(platform="gpu",
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
