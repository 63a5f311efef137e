"""The ``serve_frame`` driver: one client (a robot's camera) in a closed
loop, handing over the next frame of a pool as soon as the last one's
results are on the host.

A frame: ``runtime/pose_estimation.py::PoseEstimationNode.estimate`` on
the frame with its ground-truth instance labels and each instance's
no-entry grid; with ``icc``, then ``contrib/collision_refine.py::
IterativeCollisionCheck`` over the frame's objects (each its class's solid
CAD points, at most ``max_points``, with their inside distance, and its
target and no-entry grids) from the node's poses, refined synchronously,
as the collision node's output a robot waits for. A frame is timed from
its hand-over to its results on the host.

Set-up makes the CAD bank and the weights on the device and the pool of
frames on the host from the seed, builds the node, and serves the first
frames of the pool (every frame pads to the same bucket of 8 instances and
8 objects, so these warm every shape). The check (after the window, with
the program freed) takes a sample of the window's frames drawn from the
seed, with the frame of most objects in it, and judges each answer by what
it says:

- ``pose``: each instance's pose against the reference's per-point poses
  of the same crop: the gap to the nearest one (largest entry of the 3 x 4
  difference), and ``best``, how far that point's reference confidence
  lies below the reference's best;
- with ``icc``, ``objective``: ICC's objective as the refine reports it
  against the reference's objective at the same poses: the reported loss of
  the first iteration at the start poses (the node's poses, checked above)
  and the reported best loss at the refined poses it returns; the larger
  gap. The refined poses are not compared with a reference refine's: 30
  Adam iterations on this objective are chaotic, and a refine from the same
  start in float32 lies as far from them as one in TF32 (``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mfbench import counts, generators
from mfbench.drivers import train_step as common


@dataclasses.dataclass
class State:
    node: object
    icc_class: object
    frames: list
    objects: dict  # class id -> (solid points, inside distance) on the host
    voxel_pitch: object
    answers: list = dataclasses.field(default_factory=list)


def make_frames(ctx, bank_host):
    p = ctx.cell.params
    H, W = p["image_shape"]
    counts = generators.object_counts(ctx.seed, p["pool_frames"],
                                      *p["n_objects"])
    return [generators.scene_frame(ctx.seed, i, bank_host, H, W, n,
                                   p["voxel_dim"], p["hole_rate"])
            for i, n in enumerate(counts)]


def host_bank(ctx):
    bank = common.make_bank(ctx)
    host = {k: v.cpu().numpy() for k, v in bank.items()}
    objects = {}
    for cid in range(1, generators.N_CLASS + 1):
        keep = host["solid_mask"][cid]
        objects[cid] = (host["solid_points"][cid][keep],
                        host["solid_sdf"][cid][keep])
    return host, objects


def icc_inputs(st, frame):
    classes = list(frame["instance_to_class"].values())
    return dict(points=[st.objects[c][0] for c in classes],
                sdf=[st.objects[c][1] for c in classes],
                pitch=frame["pitch"], origin=frame["origin"],
                target=frame["target"], noentry=frame["noentry"])


def serve(st, ctx, frame):
    """The window's own call: one frame's poses (and refined poses)."""
    p = ctx.cell.params
    ids = list(frame["instance_to_class"])
    noentry = {ins: frame["noentry"][k] for k, ins in enumerate(ids)}
    with ctx.tracer.span("pose.estimate"):
        poses = st.node.estimate(frame["rgb"], frame["pcd"], frame["label"],
                                 frame["instance_to_class"],
                                 noentry_grids=noentry)
    answer = {"poses": {ins: (r["T_cad2cam"], r["confidence"])
                        for ins, r in poses.items()}}
    if not p["icc"] or len(poses) != len(ids):
        return answer
    x = icc_inputs(st, frame)
    with ctx.tracer.span("icc.build"):
        icc = st.icc_class(
            [poses[ins]["T_cad2cam"] for ins in ids], x["points"], x["sdf"],
            x["pitch"], x["origin"], x["target"], x["noentry"],
            voxel_dim=p["voxel_dim"], max_points=p["max_points"],
            device=ctx.device)
    with ctx.tracer.span("icc.refine"):
        refined, losses, _ = icc.refine(iterations=p["icc_iterations"])
    answer.update(start=[poses[ins]["T_cad2cam"] for ins in ids],
                  refined=refined, losses=losses)
    return answer


def setup(ctx):
    from morefusion_tpu_torch.contrib.collision_refine import (
        IterativeCollisionCheck,
    )
    from morefusion_tpu_torch.runtime.pose_estimation import (
        PoseEstimationNode,
    )

    c, p = ctx.cell.config, ctx.cell.params
    common.set_precision(c)
    host, objects = host_bank(ctx)
    model = generators.load_weights(
        common.build_model(c, "morefusion_tpu_torch", ctx.device), ctx.seed)

    def voxel_pitch(V, class_id):
        return float(host["diagonal"][class_id]) / V

    node = PoseEstimationNode(model, voxel_pitch=voxel_pitch,
                              image_size=c["image_size"],
                              voxel_dim=p["voxel_dim"], device=ctx.device)
    st = State(node=node, icc_class=IterativeCollisionCheck,
               frames=make_frames(ctx, host), objects=objects,
               voxel_pitch=voxel_pitch)
    for i in range(p["warmup_frames"]):
        serve(st, ctx, st.frames[i % len(st.frames)])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return st


def frame_work(st, ctx, frame):
    """The min-distance calls one frame's ICC makes: one an iteration, on
    the bucket of 8 lanes of ``max_points``, the real objects' points
    valid."""
    p = ctx.cell.params
    if not p["icc"]:
        return {}
    n = len(frame["instance_to_class"])
    lanes = 1 << (n - 1).bit_length()
    valid = sum(min(len(st.objects[c][0]), p["max_points"])
                for c in frame["instance_to_class"].values())
    work = counts.min_dist_work(lanes, p["max_points"],
                                (p["voxel_dim"],) * 3, valid)
    return {"min_dist": [work] * p["icc_iterations"]}


def window(st, ctx, seconds):
    p = ctx.cell.params
    rec = ctx.record
    t_start = time.perf_counter()
    deadline = t_start + seconds
    k = 0
    while True:
        i = (p["warmup_frames"] + k) % len(st.frames)
        frame = st.frames[i]
        with ctx.tracer.unit(k):
            t0 = time.perf_counter()
            answer = serve(st, ctx, frame)
            t1 = time.perf_counter()
        n = len(frame["instance_to_class"])
        ok = len(answer["poses"]) == n and (not p["icc"]
                                            or "refined" in answer)
        rec.units.append({"start": t0, "end": t1, "size": 1, "ok": ok,
                          "instances": len(answer["poses"]), "frame": i,
                          "work": frame_work(st, ctx, frame)})
        rec.failed += 0 if ok else 1
        st.answers.append(answer)
        k += 1
        if time.perf_counter() >= deadline:
            break
    rec.window_s = time.perf_counter() - t_start
    if p["icc"]:
        rec.extra["icc_iterations"] = p["icc_iterations"]
    rec.extra["instance_flops"] = lambda: instance_flops(ctx)


def instance_flops(ctx) -> int:
    """FLOPs of the forward of one instance at the cell's shapes, counted
    on the reference model on the meta device."""
    c, p = ctx.cell.config, ctx.cell.params
    S, V = c["image_size"], p["voxel_dim"]
    n_point = c["kwargs"].get("n_point", 1000)
    meta = torch.device("meta")
    model = common.build_model(c, "mfbench.reference", meta)
    kw = dict(class_id=torch.ones(1, dtype=torch.int64, device=meta),
              rgb=torch.empty((1, S, S, 3), device=meta),
              pcd=torch.empty((1, S, S, 3), device=meta),
              sample_indices=torch.zeros((1, n_point), dtype=torch.int64,
                                         device=meta),
              pitch=torch.empty(1, device=meta))
    if getattr(model, "with_occupancy", False):
        kw["origin"] = torch.empty((1, 3), device=meta)
        kw["grid_nontarget_empty"] = torch.empty((1, V, V, V), device=meta)
    with torch.no_grad():
        return counts.count_flops(lambda: model(**kw))


def sample(ctx, units):
    """Indices of the window's completed frames the check compares: up to
    ``check_frames`` drawn from the seed, the one of most instances among
    them."""
    done = [k for k, u in enumerate(units) if u["ok"]]
    if not done:
        return []
    n = min(ctx.cell.params["check_frames"], len(done))
    longest = max(done, key=lambda k: units[k]["instances"])
    rest = [k for k in done if k != longest]
    r = generators.rng(ctx.seed, 30)
    picked = list(r.choice(rest, n - 1, replace=False)) if n > 1 else []
    return sorted([longest] + [int(k) for k in picked])


def answers(st, ctx):
    """The sampled frames' answers, on the host; then the program is
    freed."""
    units = ctx.record.units
    got = [(units[k]["frame"], st.answers[k]) for k in sample(ctx, units)]
    st.node = None
    st.answers = []
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def reference(st, ctx, got, tf32=False):
    """For each sampled frame: the reference's per-point poses of each
    instance and its best pose as an answer; with ``icc``, the reference's
    ICC problem from the program's poses of that frame (to evaluate the
    objective at any poses) and its own refine from there."""
    from mfbench.reference import serve as plain

    c, p = ctx.cell.config, ctx.cell.params
    common.set_precision(c, tf32=tf32)
    try:
        model = generators.load_weights(
            common.build_model(c, "mfbench.reference", ctx.device),
            ctx.seed).eval()
        points = {}
        out = []
        for i, answer in got:
            frame = st.frames[i]
            ids = list(frame["instance_to_class"])
            if i not in points:
                noentry = {ins: frame["noentry"][k]
                           for k, ins in enumerate(ids)}
                points[i] = plain.predict_frame(
                    model, st.voxel_pitch, frame["rgb"], frame["pcd"],
                    frame["label"], frame["instance_to_class"], noentry,
                    c["image_size"], p["voxel_dim"])
            best = {ins: (T[np.argmax(conf)], float(conf.max()))
                    for ins, (T, conf) in points[i].items()}
            want = {"points": points[i], "poses": best}
            if "refined" in answer:
                x = icc_inputs(st, frame)
                icc = plain.collision_check(
                    answer["start"], x["points"], x["sdf"], x["pitch"],
                    x["origin"], x["target"], x["noentry"], p["voxel_dim"],
                    p["max_points"], ctx.device)
                refined, losses, _ = icc.refine(
                    iterations=p["icc_iterations"])
                want.update(icc=icc, start=answer["start"],
                            refined=refined, losses=losses)
            out.append(want)
    finally:
        common.set_precision(c)
    return out


def objective_gap(answer, icc):
    """The larger gap between the objective the refine reported (its first
    loss, its best) and the reference's at the poses it started from and
    returned."""
    losses = np.asarray(answer["losses"], np.float64)
    start = icc.loss_components(answer["start"])[0]
    end = icc.loss_components(answer["refined"])[0]
    return float(max(abs(losses[0] - start), abs(np.nanmin(losses) - end)))


def compare(got, want, ctx):
    """``[(name, gap, limit)]`` over the sampled frames (see the module's
    docstring)."""
    lim = ctx.cell.limits
    pose = best = objective = 0.0
    missing = False
    for (_, answer), ref in zip(got, want):
        if set(answer["poses"]) != set(ref["points"]):
            missing = True
            continue
        for ins, (T, _) in answer["poses"].items():
            Ts, conf = ref["points"][ins]
            d = np.abs(Ts[:, :3, :] - np.asarray(T)[None, :3, :]).max((1, 2))
            k = int(np.argmin(d))
            pose = max(pose, float(d[k]))
            best = max(best, float(conf.max() - conf[k]))
        if "icc" in ref:
            if "refined" not in answer:
                missing = True
                continue
            objective = max(objective, objective_gap(answer, ref["icc"]))
    if missing or not got:
        pose = best = objective = float("inf")
    out = [("pose", pose, lim["pose"]), ("best", best, lim["best"])]
    if ctx.cell.params["icc"]:
        out.append(("objective", objective, lim["objective"]))
    return out
