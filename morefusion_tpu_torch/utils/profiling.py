"""Profiling & step timing (aux subsystem).

Port of ``morefusion_tpu/utils/profiling.py`` on ``torch.profiler``:

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  with the host (CPU) and, in PyTorch built for CUDA, CUDA activities;
  writes a Chrome trace (``*.pt.trace.json``) into ``logdir`` (view in
  Perfetto, ``chrome://tracing`` or TensorBoard's PyTorch profiler);
- ``annotate(name)``: ``torch.profiler.record_function``, labeling a host
  span inside a capture;
- ``StepTimer``: rolling step-time / throughput statistics for training
  loops (p50/p90, samples/s), the trace-free everyday tool.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, Optional

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace into ``logdir``. The activities
    are ``torch.profiler.supported_activities()``: CUDA's kernels are in
    the trace wherever PyTorch was built for CUDA."""
    import torch

    with torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield


def annotate(name: str):
    """Label a host-side span inside an active trace."""
    import torch

    return torch.profiler.record_function(name)


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
