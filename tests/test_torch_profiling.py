"""The port's timers and profiler against ``morefusion_tpu.utils``:
``timer`` and ``StepTimer`` of both packages under the same patched clock
(elapsed times, printed lines and statistics equal); ``trace`` and
``annotate`` on the CPU write a Chrome trace that holds the annotated
span and the operators run inside it."""

import glob
import json
import time

import numpy as np
import pytest
import torch

from morefusion_tpu import utils as JU
from morefusion_tpu_torch import utils as TU

torch.set_num_threads(2)


class Clock:
    """``time.perf_counter`` stepping through seeded increments."""

    def __init__(self, seed):
        self._steps = iter(np.cumsum(np.random.RandomState(seed).uniform(
            0.001, 0.1, 1000)))

    def __call__(self):
        return float(next(self._steps))


@pytest.mark.parametrize("name,quiet", [("load", False), ("save", True),
                                        (None, False)])
def test_timer(monkeypatch, capsys, name, quiet):
    seen = []
    for U in (JU, TU):
        monkeypatch.setattr(time, "perf_counter", Clock(0))
        with U.timer(name, quiet=quiet) as t:
            assert t.elapsed is None
        seen.append((t.elapsed, capsys.readouterr().out))
    assert seen[1] == seen[0]
    assert (seen[1][1] == "") == quiet
    if name is None:  # the caller's file and line name the span
        assert "test_torch_profiling.py" in seen[1][1]


@pytest.mark.parametrize("window,ticks,batch", [(100, 30, 16), (5, 12, 1),
                                                (10, 1, 4)])
def test_step_timer(monkeypatch, window, ticks, batch):
    seen = []
    for U in (JU, TU):
        monkeypatch.setattr(time, "perf_counter", Clock(1))
        st = U.StepTimer(window=window)
        dts = [st.tick() for _ in range(ticks)]
        seen.append((dts, st.stats(batch_size=batch)))
    assert seen[1] == seen[0]
    assert seen[1][0][0] is None
    assert (seen[1][1] == {}) == (ticks == 1)


def test_trace_holds_the_annotated_span(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with TU.trace(logdir):
        with TU.annotate("pose_step"):
            y = (x @ x).relu().sum()
    assert torch.isfinite(y)
    (path,) = glob.glob(f"{logdir}/*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "pose_step"]
    inside = [e["name"] for e in events
              if e.get("ph") == "X" and e.get("cat") == "cpu_op"
              and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]]
    assert "aten::mm" in inside and "aten::relu" in inside
