"""The training loop of the port.

Port of ``morefusion_tpu/training/loop.py::fit``: Adam at 1e-4 (or a
schedule), the loss schedule ``add -> add/add_s`` after epoch 1,
evaluation every ``eval_interval`` epochs with per-class ADD AUC, snapshots
latest / best ADD / best AUC, ``log.json`` and ``args.json``; data
parallel over the ranks of the process group (``torchrun``), every step
through ``make_dp_train_step`` and every evaluation through
``make_dp_eval_step``, as JAX's runs every step through its ``shard_map``
steps.

Data parallelism: every rank draws the same global shuffle from ``seed``
and loads only its ``local_batch_slice`` of each batch; gradients and
metrics are averaged over the ranks; the evaluation's records are gathered
to rank 0 (``gather_obj``), which summarizes them and alone writes
``args.json``, the log, the snapshots and ``timing.json``. All ranks run
the same number of steps. In one process all of it is the single-device
loop.

The transfer form: when the train set's batches carry ``z`` (a packed set
with ``transfer=True``), the schema comes from the first batch, each rank
packs its rows into one uint8 buffer (``training/transfer.py``) in the copy
thread and ships it in one copy; the steps unpack it and rebuild the cloud
on the device. The val loader takes the same form when its set has it.

The host prepares batches in ``BatchLoader``'s thread (or forked workers);
a second thread packs, pins and copies each batch to the card on a stream
of its own, so that both overlap the step on the card. ``timing.json`` in
the run's directory records where a step's time went on the host: the
batch's preparation (in ``BatchLoader``'s thread; not recorded with worker
processes), its packing (transfer form) and its copy (in the copy thread),
the loop's wait for it, the bytes a batch shipped, and the ms of each
evaluation batch and checkpoint save.

Differences from the JAX loop: the model comes initialised (JAX draws one
train batch to run ``model.init``, which consumes the loader's first
shuffle, so JAX's epoch ``e`` reads the port's permutation ``e + 1``); the
transfer schema is built from the first batch of the first epoch, which
the loop then trains on.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
from .checkpoints import (
    CheckpointManager,
    import_backbone_npz,
    import_params_npz,
)
from .data import BatchLoader
from .evaluator import Evaluator
from .reporting import LogReport, write_args
from .trainer import (
    CadPointBank,
    create_train_state,
    make_dp_eval_step,
    make_dp_train_step,
)
from .transfer import TransferSchema

#: bytes of the buffer that gathers one rank's evaluation records
EVAL_GATHER_BYTES = 1 << 22


class LeakBudgetExit(Exception):
    """Raised after a clean checkpoint save when the host's resident memory
    crosses the budget (``rss_exit_gb``), so that a wrapper can relaunch the
    run with ``--resume`` (exit code 42)."""


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def _pipe_stage(src_iter, fn, stop, depth: int = 2):
    """Run ``fn`` over ``src_iter`` in a worker thread, yielding results.

    Bounded puts re-check ``stop`` so an early-exiting consumer never
    leaves the worker blocked on a full queue; exceptions propagate to the
    consumer. Closing the generator sets ``stop`` and joins the worker, so
    no thread is left running (a daemon thread still in native code when
    the interpreter exits can abort the process).
    """
    q: queue.Queue = queue.Queue(maxsize=depth)

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in src_iter:
                if stop.is_set():
                    return
                if not _put(fn(item)):
                    return
        except Exception as e:
            _put(e)
            return
        _put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def _prefetch_to_device(host_iter, device, timing, schema=None,
                        depth: int = 2):
    """Host batches as tensors on ``device``: a thread packs each batch
    into ``schema``'s buffer (when given), pins it and copies it with
    ``non_blocking=True`` on a stream of its own; the consumer's stream
    waits for that copy's event. Yields the dict of tensors, or the packed
    buffer. ``timing`` collects the host ms of each batch's packing
    (``pack_ms``) and of its pinning and copy (``copy_ms``), and the bytes
    of the last batch shipped (``batch_bytes``)."""
    stop = threading.Event()
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def to_device(hb):
        if schema is not None:
            t0 = time.perf_counter()
            hb = {"buf": schema.pack(hb)}
            timing.setdefault("pack_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
        timing["batch_bytes"] = int(sum(np.asarray(v).nbytes
                                        for v in hb.values()))
        t0 = time.perf_counter()
        if not cuda:
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in hb.items()}
            timing["copy_ms"].append((time.perf_counter() - t0) * 1e3)
            return out, None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   .pin_memory().to(device, non_blocking=True)
                   for k, v in hb.items()}
            event = torch.cuda.Event()
            event.record(stream)
        timing["copy_ms"].append((time.perf_counter() - t0) * 1e3)
        return out, event

    try:
        for out, event in _pipe_stage(host_iter, to_device, stop, depth):
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in out.values():
                    t.record_stream(current)
            yield out["buf"] if schema is not None else out
    finally:
        stop.set()


def _first_and_rest(loader):
    """(the loader's first batch, an iterator over all of its batches of
    that epoch, the first included), or (None, empty)."""
    it = iter(loader)
    first = next(it, None)
    if first is None:
        return None, iter(())
    return first, itertools.chain([first], it)


def _schema_of(batch):
    return None if batch is None or "z" not in batch else TransferSchema(
        batch)


def _replicate_state(state, mesh):
    """Rank 0's model, optimizer, schedule and step on every rank (after
    rank 0 alone restored a snapshot)."""
    if mesh.world_size == 1:
        return
    snap = None
    if parallel.is_primary():
        snap = dict(
            model={k: v.cpu() for k, v in state.model.state_dict().items()},
            optimizer=_to_cpu(state.optimizer.state_dict()),
            scheduler=state.scheduler.state_dict(), step=state.step)
    box = [snap]
    dist.broadcast_object_list(box, src=0)
    if not parallel.is_primary():
        snap = box[0]
        state.model.load_state_dict(snap["model"])
        state.optimizer.load_state_dict(snap["optimizer"])
        state.scheduler.load_state_dict(snap["scheduler"])
        state.step = snap["step"]


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def fit(
    *,
    model,
    models_bank,
    train_dataset,
    val_dataset,
    out_dir: str,
    transform_train,
    transform_val,
    n_fg_class: int,
    batch_size: int = 16,
    epochs: int = 30,
    learning_rate=1e-4,
    loss: str = "add/add_s",
    eval_interval: float = 0.25,
    log_interval: int = 20,
    seed: int = 0,
    resume: bool = False,
    pretrained_model: Optional[str] = None,
    pretrained_backbone: Optional[str] = None,
    max_steps: Optional[int] = None,
    args_dict: Optional[dict] = None,
    num_workers: int = 0,
    device_augment: bool = False,
    val_batch_size: Optional[int] = None,
    rss_exit_gb: float = 0.0,
    device="cuda",
):
    """Train ``model`` (moved to ``device``: ``cuda:LOCAL_RANK`` for
    ``"cuda"`` under ``torchrun``); returns (state, the last evaluation's
    summary, on rank 0; ``{}`` on the other ranks). ``batch_size`` and
    ``val_batch_size`` are global: each rank takes its slice.
    ``learning_rate`` is a number or a function of the step
    (``cli/train.py``'s cosine schedule). The model's occupancy branch
    (``model.with_occupancy``) takes the occupancy grids; the occupancy loss
    term is on for the ``+occupancy`` losses only. ``device_augment`` runs
    the photometric and point-cloud augmentation inside the step (the
    packed path, whose host does the mask truncation alone). The val loader
    drops its last partial batch: with fewer val crops than
    ``val_batch_size`` (48) no evaluation runs and the summary stays
    empty."""
    mesh = parallel.data_mesh(device)
    device = mesh.device
    primary = parallel.is_primary()
    if primary:
        write_args(out_dir, args_dict or {})
    log = LogReport(out_dir) if primary else None
    ckpt = CheckpointManager(out_dir) if primary else None
    model.to(device)
    bank = CadPointBank.build(models_bank, n_fg_class, device=device)

    train_loader = BatchLoader(
        train_dataset,
        batch_size,
        transform_train,
        shuffle=True,
        seed=seed,
        num_workers=num_workers,
        shard=parallel.local_batch_slice(batch_size, mesh),
    )
    val_batch_size = val_batch_size or 48
    val_loader = BatchLoader(
        val_dataset,
        val_batch_size,
        transform_val,
        shuffle=False,
        drop_last=True,
        num_workers=num_workers,
        shard=parallel.local_batch_slice(val_batch_size, mesh),
    )

    if pretrained_model:
        # weights only; the optimizer and the step start fresh
        import_params_npz(model, pretrained_model)
        print(f"initialized params from {pretrained_model}")
    if pretrained_backbone:
        import_backbone_npz(model, pretrained_backbone)
        print(f"initialized backbone from {pretrained_backbone}")
    state = create_train_state(model, learning_rate)
    if resume and primary:
        ckpt.restore_latest(state)
    if resume:
        _replicate_state(state, mesh)

    steps_per_epoch = max(len(train_loader), 1)
    eval_every = max(int(steps_per_epoch * eval_interval), 1)
    total_steps = (
        epochs * steps_per_epoch if max_steps is None else max_steps
    )
    timing = dict(host_prep_ms=[], copy_ms=[], wait_ms=[],
                  eval_ms_per_batch=[], save_latest_ms=[], save_best_ms=[])
    train_loader.batch_ms = timing["host_prep_ms"]  # serial loader only

    # the steps are built with the first train batch, whose keys say
    # whether the set ships in the transfer form
    train_step = None
    val_schema = _schema_of(next(iter(val_loader), None))
    eval_step = make_dp_eval_step(model, bank, mesh,
                                  transfer_schema=val_schema)

    def run_eval():
        outs = []
        for batch in _prefetch_to_device(val_loader, device,
                                         dict(copy_ms=[]), val_schema):
            t0 = time.perf_counter()
            out = eval_step(batch)
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
            timing["eval_ms_per_batch"].append(
                (time.perf_counter() - t0) * 1e3)
        per_rank = parallel.gather_obj(outs, EVAL_GATHER_BYTES)
        if per_rank is None:
            return {}
        ev = Evaluator()
        for rows in zip(*per_rank):  # the global batches' order
            for out in rows:
                ev.add_batch(out)
        return ev.summarize()

    def timed_save(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        timing[key].append((time.perf_counter() - t0) * 1e3)
        return out

    step = state.step
    step0 = step  # nonzero when resumed; rate math uses deltas
    summary = {}
    t_start = time.time()
    win_step, win_t = step, t_start
    done = False
    for _ in range(epochs):
        if done or step >= total_steps:
            break
        # loss schedule: 'add' only during epoch 0, then add/add_s, from
        # the global step so that a resumed run keeps it
        use_symmetric = "add_s" in loss and step >= steps_per_epoch
        if train_step is None:
            first, host_batches = _first_and_rest(train_loader)
            schema = _schema_of(first)
            train_step = make_dp_train_step(
                model,
                bank,
                mesh,
                # the occupancy grids feed the model whenever it has the
                # branch; the occupancy loss term only for "+occupancy"
                occupancy_loss_term="occupancy" in loss,
                augment=device_augment,
                transfer_schema=schema,
            )
        else:
            host_batches = train_loader
        batches = _prefetch_to_device(host_batches, device, timing, schema)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            timing["wait_ms"].append((time.perf_counter() - t0) * 1e3)
            state, metrics = train_step(state, batch, use_symmetric,
                                        seed=seed)
            step += 1

            if step % log_interval == 0:
                # the metrics are the ranks' mean: every rank checks them
                m = {f"main/{k}": float(v) for k, v in metrics.items()}
                if not np.isfinite(m.get("main/loss", 0.0)):
                    raise FloatingPointError(
                        f"non-finite loss at step {step}: {m}")
                now = time.time()
                m["main/sps"] = (step - step0) / (now - t_start)
                # the windowed rate leaves out evaluation pauses
                m["main/sps_window"] = (step - win_step) / max(
                    now - win_t, 1e-9)
                win_step, win_t = step, now
                if primary:
                    log.report(m, step=step, epoch=step / steps_per_epoch)

            if step % eval_every == 0:
                summary = run_eval()
                if summary:
                    log.report(
                        {k: v for k, v in summary.items()
                         if k.count("/") <= 2},
                        step=step,
                        epoch=step / steps_per_epoch,
                    )
                    timed_save("save_latest_ms", ckpt.save_latest, state,
                               step)
                    timed_save("save_best_ms", ckpt.save_best, model,
                               "validation/main/add_or_add_s",
                               summary.get("main/add_or_add_s", np.inf),
                               "min")
                    timed_save("save_best_ms", ckpt.save_best, model,
                               "validation/main/auc",
                               summary.get("main/add_or_add_s/auc", 0.0),
                               "max")
                win_step, win_t = step, time.time()
                # the leak-budget restart point: latest was just saved (one
                # process only: a rank leaving alone would hang the others)
                if (
                    rss_exit_gb
                    and mesh.world_size == 1
                    and step < total_steps
                    and _rss_gb() > rss_exit_gb
                ):
                    raise LeakBudgetExit(
                        f"RSS {_rss_gb():.1f} GB > {rss_exit_gb} GB "
                        f"at step {step}; checkpoint saved, relaunch "
                        f"with --resume"
                    )

            if step >= total_steps:
                done = True
                break
        batches.close()

    if primary:
        timed_save("save_latest_ms", ckpt.save_latest, state, step)
        with open(os.path.join(out_dir, "timing.json"), "w") as f:
            json.dump(dict(timing, steps=step - step0,
                           steps_per_epoch=steps_per_epoch), f, indent=1)
    parallel.barrier()
    return state, summary
