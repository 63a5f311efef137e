"""The ``train_step`` driver: the port's train step
(``training/trainer.py::make_train_step``) in a loop over a pool of
batches, as ``training/loop.py::fit`` drives it.

Set-up makes the CAD bank and the model's weights on the device from the
seed, a pool of distinct batches on the host, packs them in the transfer
form (``training/transfer.py``) into pinned memory, and builds one train
state. Its first steps go through the window's own call on the pool's
first batches: the reference follows the first three, then a few more warm
up. The window keeps calling the same step on the same state, each batch
copied from pinned memory as the loop copies it, at most two steps in
flight (a CUDA event at each step's end).

The check (after the window, with the program freed): the losses of the
first three steps, each parameter's first gradient (from Adam's first
moment after one step) and each parameter's change after three steps (kept
before the fourth), against the plain reference's, by the worst leaf: the
gap between the two norms over the larger of the reference leaf's norm and
the median leaf's. Leaves whose reference gradient is under a thousandth
of the median leaf's move by Adam's round-off alone and are left out of
the change.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

from mfbench import counts, generators

FOLLOWED_STEPS = 3
SMALL_GRADIENT = 1e-3  # of the median leaf's first gradient


def set_precision(config, tf32: bool = False):
    """fp32 matmuls and convolutions as the configuration states (TF32
    off), or TF32 on for the control."""
    on = bool(tf32 or config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def model_class(config, package: str):
    module = importlib.import_module(f"{package}.{config['module']}")
    return getattr(module, config["class"])


def build_model(config, package: str, device):
    with torch.device(device):
        model = model_class(config, package)(**config["kwargs"])
    return model


def host_batches(ctx):
    p = ctx.cell.params
    return [generators.train_batch(
        ctx.seed, i, p["batch"], p["image_size"], p["voxel_dim"],
        p["hole_rate"], p["target_rate"], p["noentry_rate"])
        for i in range(p["pool"])]


def make_bank(ctx):
    c = ctx.cell.config
    return generators.cad_bank(ctx.seed, c["symmetric_classes"], ctx.device,
                               c["max_solid_points"])


@dataclasses.dataclass
class State:
    model: object
    train_state: object
    step: object
    packed: torch.Tensor
    batch_work: list  # per pool batch: each kernel's calls' (ops, bytes)
    followed: dict  # the program's numbers of the first steps
    next_index: int = 0
    events: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)


def kernel_work(ctx, bank, raw):
    """Per batch of the pool, the work its knn and min-distance calls
    need: knn of every predicted pose's CAD points against the true ones'
    (one call a step), min-distance of each lane's solid points under its
    best pose (one call a step, with the occupancy term)."""
    p, c = ctx.cell.params, ctx.cell.config
    B = p["batch"]
    n_point = c["kwargs"].get("n_point", 1000)
    n_cad = bank["points"].shape[1]
    solid = bank["solid_mask"].sum(1).cpu().numpy()
    dims = (p["voxel_dim"],) * 3
    out = []
    for b in raw:
        work = {"knn": [counts.knn_work(B, n_cad, n_point * n_cad)]}
        if c["occupancy_loss_term"]:
            work["min_dist"] = [counts.min_dist_work(
                B, bank["solid_points"].shape[1], dims,
                int(solid[b["class_id"]].sum()))]
        out.append(work)
    return out


def issue_step(st, ctx, use_symmetric):
    """One step of the window's loop: copy the next batch, step, and mark
    the step's end with a CUDA event."""
    i = st.next_index
    st.next_index += 1
    with ctx.tracer.span("train.copy"):
        buf = st.packed[i % len(st.packed)].to(ctx.device, non_blocking=True)
    with ctx.tracer.span("train.step"):
        st.train_state, metrics = st.step(st.train_state, buf, use_symmetric,
                                          seed=ctx.seed)
    if ctx.device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        st.events.append(event)
        if len(st.events) > 2:
            st.events[-3].synchronize()
    return i, metrics["loss"]


def setup(ctx):
    from morefusion_tpu_torch.training import trainer, transfer

    c, p = ctx.cell.config, ctx.cell.params
    set_precision(c)
    bank = make_bank(ctx)
    program_bank = trainer.CadPointBank(
        points=bank["points"], symmetric=bank["symmetric"],
        solid_points=bank["solid_points"], solid_sdf=bank["solid_sdf"],
        solid_mask=bank["solid_mask"])
    model = generators.load_weights(
        build_model(c, "morefusion_tpu_torch", ctx.device), ctx.seed)
    raw = host_batches(ctx)
    schema = transfer.TransferSchema(raw[0])
    packed = torch.from_numpy(np.stack([schema.pack(b) for b in raw]))
    if ctx.device.type == "cuda":
        packed = packed.pin_memory()
    train_state = trainer.create_train_state(model, c["learning_rate"])
    step = trainer.make_train_step(
        model, program_bank, occupancy_loss_term=c["occupancy_loss_term"],
        augment=p["augment"], transfer_schema=schema)
    st = State(model=model, train_state=train_state, step=step,
               packed=packed, batch_work=kernel_work(ctx, bank, raw),
               followed={})

    params = dict(model.named_parameters())
    before = {n: t.detach().clone() for n, t in params.items()}
    losses = []
    beta1 = train_state.optimizer.defaults["betas"][0]
    for k in range(FOLLOWED_STEPS):
        losses.append(issue_step(st, ctx, p["use_symmetric"])[1])
        if k == 0:
            # a step that left the optimizer untouched has no moment: 0
            moments = {n: train_state.optimizer.state.get(t, {}).get(
                "exp_avg", torch.zeros((), device=ctx.device))
                for n, t in params.items()}
            st.followed["grad"] = {
                n: torch.linalg.vector_norm(m) / (1.0 - beta1)
                for n, m in moments.items()}
    st.followed["change"] = {
        n: torch.linalg.vector_norm(t.detach() - before[n])
        for n, t in params.items()}
    st.followed["loss"] = losses
    del before
    for _ in range(p["warmup_steps"]):
        issue_step(st, ctx, p["use_symmetric"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    st.events.clear()
    return st


def window(st, ctx, seconds):
    p = ctx.cell.params
    rec = ctx.record
    t_start = time.perf_counter()
    deadline = t_start + seconds
    k = 0
    while True:
        with ctx.tracer.unit(k):
            t0 = time.perf_counter()
            i, loss = issue_step(st, ctx, p["use_symmetric"])
            st.losses.append(loss)
            rec.units.append({"start": t0, "end": time.perf_counter(),
                              "size": p["batch"],
                              "work": st.batch_work[i % len(st.packed)]})
        k += 1
        if time.perf_counter() >= deadline:
            break
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    rec.window_s = time.perf_counter() - t_start
    rec.failed = int((~torch.isfinite(torch.stack(st.losses))).sum())
    if st.events:
        rec.extra["step_ms"] = [a.elapsed_time(b) for a, b in
                                zip(st.events, st.events[1:])]
    rec.extra["step_flops"] = lambda: step_flops(ctx)


def step_flops(ctx) -> int:
    """FLOPs of one train step's forward and backward at the cell's
    shapes, counted on the reference model on the meta device (so nothing
    runs): the model and the ADD/ADD-S loss. The augmentation's resize
    products (about 3 GFLOP at B = 16) are not counted."""
    from mfbench.reference.models import losses

    c, p = ctx.cell.config, ctx.cell.params
    B, S, V = p["batch"], p["image_size"], p["voxel_dim"]
    n_point = c["kwargs"].get("n_point", 1000)
    meta = torch.device("meta")
    model = build_model(c, "mfbench.reference", meta)

    def fwd_bwd():
        kw = dict(class_id=torch.ones(B, dtype=torch.int64, device=meta),
                  rgb=torch.empty((B, S, S, 3), device=meta),
                  pcd=torch.empty((B, S, S, 3), device=meta),
                  sample_indices=torch.zeros((B, n_point), dtype=torch.int64,
                                             device=meta))
        if hasattr(model, "voxel_dim"):
            kw["pitch"] = torch.empty(B, device=meta)
        if getattr(model, "with_occupancy", False):
            kw["origin"] = torch.empty((B, 3), device=meta)
            kw["grid_nontarget_empty"] = torch.empty((B, V, V, V),
                                                     device=meta)
        quat, trans, conf = model(**kw)
        n_cad = generators.N_CAD_POINTS
        value = losses.pose_loss(
            quaternion_pred=quat, translation_pred=trans,
            confidence_pred=conf,
            quaternion_true=torch.empty((B, 4), device=meta),
            translation_true=torch.empty((B, 3), device=meta),
            cad_points=torch.empty((B, n_cad, 3), device=meta),
            symmetric=torch.zeros(B, dtype=torch.bool, device=meta))
        value.backward()

    return counts.count_flops(fwd_bwd)


def _norm_gaps(got, want, names):
    """Worst leaf of ``|got - want| / max(want, median of want)``."""
    floor = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], floor, 1e-30)
               for n in names)


def answers(st, ctx):
    """The program's numbers of its first steps, on the host; then the
    program is freed, so that the reference runs on an empty card."""
    got = {"loss": [float(x) for x in st.followed["loss"]]}
    for key in ("grad", "change"):
        got[key] = {n: float(v) for n, v in st.followed[key].items()}
    st.model = st.train_state = st.step = None
    st.events.clear()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def reference(st, ctx, got, tf32=False):
    """The plain reference's numbers of the same steps from the same
    inputs; with ``tf32`` computed in TF32 (the control)."""
    from mfbench.reference import train as plain

    c, p = ctx.cell.config, ctx.cell.params
    set_precision(c, tf32=tf32)
    try:
        model = generators.load_weights(
            build_model(c, "mfbench.reference", ctx.device), ctx.seed)
        losses, grad, change = plain.follow(
            model, make_bank(ctx), host_batches(ctx)[:FOLLOWED_STEPS],
            ctx.seed, FOLLOWED_STEPS, c["learning_rate"],
            c["occupancy_loss_term"], p["augment"], p["use_symmetric"])
    finally:
        set_precision(c)
    return {"loss": losses,
            "grad": {n: float(torch.linalg.vector_norm(g))
                     for n, g in grad.items()},
            "change": {n: float(torch.linalg.vector_norm(d))
                       for n, d in change.items()}}


def numbers(got, want):
    """Every number the check can compare: ``loss``, the worst of the
    followed steps' loss gaps, and ``loss_early`` of all but the last;
    ``grad``, the worst leaf's first gradient; ``change``, the worst moved
    leaf's change, and ``change_median``, the median moved leaf's. A cell
    compares those its ``limits`` name."""
    names = sorted(want["grad"])
    floor = float(np.median([want["grad"][n] for n in names]))
    moved = [n for n in names
             if want["grad"][n] >= SMALL_GRADIENT * floor]
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(got["loss"], want["loss"])]
    floor_c = float(np.median([want["change"][n] for n in moved]))
    changes = [abs(got["change"][n] - want["change"][n])
               / max(want["change"][n], floor_c, 1e-30) for n in moved]
    return {"loss": max(steps), "loss_early": max(steps[:-1]),
            "grad": _norm_gaps(got["grad"], want["grad"], names),
            "change": max(changes),
            "change_median": float(np.median(changes))}


def compare(got, want, ctx):
    """``[(name, gap, limit)]`` of the numbers the cell's limits name."""
    found = numbers(got, want)
    return [(name, found[name], limit)
            for name, limit in ctx.cell.limits.items()]


def diagnose(got, want):
    """For the readings: each step's loss gap, and the worst leaves of the
    first gradient and of the change."""
    names = sorted(want["grad"])

    def worst(key):
        floor = float(np.median([want[key][n] for n in names]))
        gaps = {n: abs(got[key][n] - want[key][n])
                / max(want[key][n], floor, 1e-30) for n in names}
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    return {"loss_steps": [abs(a - b) / max(abs(b), 1e-30)
                           for a, b in zip(got["loss"], want["loss"])],
            "grad_worst": worst("grad"), "change_worst": worst("change"),
            "numbers": numbers(got, want)}
