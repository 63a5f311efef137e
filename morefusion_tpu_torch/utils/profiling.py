"""Profiling & step timing (aux subsystem).

Port of ``morefusion_tpu/utils/profiling.py`` on ``torch.profiler``:

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  with the host (CPU) and, in PyTorch built for CUDA, CUDA activities;
  writes a Chrome trace (``*.pt.trace.json``) into ``logdir`` (view in
  Perfetto, ``chrome://tracing`` or TensorBoard's PyTorch profiler);
- ``annotate(name)``: the program's span. With no profiler running it
  returns one shared null context and costs a flag check. While any
  ``torch.profiler.profile`` runs (``trace``, ``cli.profile_train
  --trace-dir``, a benchmark's traced stretch) it is a
  ``torch.profiler.record_function`` range, on the profiler's clock
  beside the device's kernels and copies, and it keeps the span's
  interval on the device (CUDA events on the current stream once CUDA is
  in use in the process, else the host's ``perf_counter``);
- ``count(name, n)``: a counter, kept only while a profiler runs;
- ``recorded()``: the intervals (ms, by span name) and counters of the
  latest traced stretch. A stretch begins at the first span or count that
  sees a profiler after one that saw none;
- ``StepTimer``: rolling step-time / throughput statistics for training
  loops (p50/p90, samples/s), the trace-free everyday tool.

The program's spans are named by layer: ``trainer.*`` (the train step
and its parts, ``training/trainer.py``), ``model.*`` (the models'
branches) and ``pose_node.*`` (``runtime/pose_estimation.py``, with the
counters ``pose_node.instances`` and ``pose_node.lanes``).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace into ``logdir``. The activities
    are ``torch.profiler.supported_activities()``: CUDA's kernels are in
    the trace wherever PyTorch was built for CUDA."""
    with torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield


_NULL = contextlib.nullcontext()
# whether the latest span or count saw no profiler: the next one that sees
# a profiler begins a new stretch
_untraced = True
_intervals: Dict[str, List[tuple]] = {}  # name -> [(start, end) marks]
_counters: Dict[str, int] = {}


def _begin_stretch():
    global _untraced
    if _untraced:
        _untraced = False
        _intervals.clear()
        _counters.clear()


def _mark():
    """A point on the device's timeline: a CUDA event on the current
    stream once CUDA is in use, else the host's clock."""
    if torch.cuda.is_initialized():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


class _Span:
    __slots__ = ("_name", "_range", "_start")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        _begin_stretch()
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        self._start = _mark()
        return self

    def __exit__(self, *exc):
        _intervals.setdefault(self._name, []).append((self._start, _mark()))
        self._range.__exit__(*exc)
        return False


def annotate(name: str):
    """The span ``name``: nothing with no profiler running; a
    ``record_function`` range with its device interval kept while one
    runs."""
    global _untraced
    if not _profiler_enabled():
        _untraced = True
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    global _untraced
    if not _profiler_enabled():
        _untraced = True
        return
    _begin_stretch()
    _counters[name] = _counters.get(name, 0) + n


def _elapsed_ms(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


def recorded() -> dict:
    """``{"device_ms": {name: [ms, ...]}, "counters": {name: n}}`` of the
    latest traced stretch: each span call's interval on the device, in
    call order (waiting for each interval's end on the device)."""
    return {"device_ms": {name: [_elapsed_ms(a, b) for a, b in marks]
                          for name, marks in _intervals.items()},
            "counters": dict(_counters)}


class StepTimer:
    """Rolling step-time statistics."""

    def __init__(self, window: int = 100):
        self._times = deque([], window)
        self._last: Optional[float] = None
        self._count = 0

    def tick(self) -> Optional[float]:
        """Mark a step boundary; returns the last step's duration."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
        self._last = now
        self._count += 1
        return dt

    def stats(self, batch_size: int = 1) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "step_time_mean": float(arr.mean()),
            "step_time_p50": float(np.percentile(arr, 50)),
            "step_time_p90": float(np.percentile(arr, 90)),
            "steps_per_s": float(1.0 / arr.mean()),
            "samples_per_s": float(batch_size / arr.mean()),
        }
