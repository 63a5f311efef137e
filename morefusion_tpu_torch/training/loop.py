"""The training loop of the port.

Port of ``morefusion_tpu/training/loop.py::fit`` on one device: Adam at
1e-4 (or a schedule), the loss schedule ``add -> add/add_s`` after epoch 1,
evaluation every ``eval_interval`` epochs with per-class ADD AUC, snapshots
latest / best ADD / best AUC, ``log.json`` and ``args.json``.

The host prepares batches in ``BatchLoader``'s thread (or forked workers);
a second thread pins each batch and copies it to the card on a stream of
its own, so that both overlap the step on the card. ``timing.json`` in the
run's directory records where a step's time went on the host: the batch's
preparation (in ``BatchLoader``'s thread; not recorded with worker
processes), its copy (in the copy thread) and the loop's wait for it, and
the ms of each evaluation batch and checkpoint save.

Differences from the JAX loop: the model comes initialised (JAX draws one
train batch to run ``model.init``, which consumes the loader's first
shuffle, so JAX's epoch ``e`` reads the port's permutation ``e + 1``); one
device, no data parallelism; no transfer form.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

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
    make_eval_step,
    make_train_step,
)


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


def _prefetch_to_device(host_iter, device, timing, depth: int = 2):
    """Host batches as tensors on ``device``: a thread pins each batch and
    copies it with ``non_blocking=True`` on a stream of its own; the
    consumer's stream waits for that copy's event. ``timing["copy_ms"]``
    collects the host ms of each batch's pinning and copy."""
    stop = threading.Event()
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def to_device(hb):
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
            yield out
    finally:
        stop.set()


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
    """Train ``model`` (moved to ``device``); returns (state, the last
    evaluation's summary). ``learning_rate`` is a number or a function of
    the step (``cli/train.py``'s cosine schedule). The model's occupancy
    branch (``model.with_occupancy``) takes the occupancy grids; the
    occupancy loss term is on for the ``+occupancy`` losses only.
    ``device_augment`` runs the photometric and point-cloud augmentation
    inside the step (the packed path, whose host does the mask truncation
    alone). The val loader drops its last partial batch: with fewer val
    crops than ``val_batch_size`` (48) no evaluation runs and the summary
    stays empty."""
    device = torch.device(device)
    write_args(out_dir, args_dict or {})
    log = LogReport(out_dir)
    ckpt = CheckpointManager(out_dir)
    model.to(device)
    bank = CadPointBank.build(models_bank, n_fg_class, device=device)

    train_loader = BatchLoader(
        train_dataset,
        batch_size,
        transform_train,
        shuffle=True,
        seed=seed,
        num_workers=num_workers,
    )
    val_loader = BatchLoader(
        val_dataset,
        val_batch_size or 48,
        transform_val,
        shuffle=False,
        drop_last=True,
        num_workers=num_workers,
    )

    if pretrained_model:
        # weights only; the optimizer and the step start fresh
        import_params_npz(model, pretrained_model)
        print(f"initialized params from {pretrained_model}")
    if pretrained_backbone:
        import_backbone_npz(model, pretrained_backbone)
        print(f"initialized backbone from {pretrained_backbone}")
    state = create_train_state(model, learning_rate)
    if resume:
        ckpt.restore_latest(state)

    train_step = make_train_step(
        model,
        bank,
        # the occupancy grids feed the model whenever it has the branch;
        # the occupancy loss term only for the "+occupancy" losses
        occupancy_loss_term="occupancy" in loss,
        augment=device_augment,
    )
    eval_step = make_eval_step(model, bank)

    steps_per_epoch = max(len(train_loader), 1)
    eval_every = max(int(steps_per_epoch * eval_interval), 1)
    total_steps = (
        epochs * steps_per_epoch if max_steps is None else max_steps
    )
    timing = dict(host_prep_ms=[], copy_ms=[], wait_ms=[],
                  eval_ms_per_batch=[], save_latest_ms=[], save_best_ms=[])
    train_loader.batch_ms = timing["host_prep_ms"]  # serial loader only

    def run_eval():
        ev = Evaluator()
        for batch in _prefetch_to_device(val_loader, device,
                                         dict(copy_ms=[])):
            t0 = time.perf_counter()
            ev.add_batch(eval_step(batch))  # reads the records back
            timing["eval_ms_per_batch"].append(
                (time.perf_counter() - t0) * 1e3)
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
        batches = _prefetch_to_device(train_loader, device, timing)
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
                # the leak-budget restart point: latest was just saved
                if (
                    rss_exit_gb
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

    timed_save("save_latest_ms", ckpt.save_latest, state, step)
    with open(os.path.join(out_dir, "timing.json"), "w") as f:
        json.dump(dict(timing, steps=step - step0,
                       steps_per_epoch=steps_per_epoch), f, indent=1)
    return state, summary
