"""The reader ``layer_metrics/pose.select_kernel_pct.py`` in a tiny traced
run of the pose cell on the CPU, where the node selects with the kernel's
plain version, and in an untraced run, which reports nothing."""

import pytest

from mfbench import harness, program_spans, readers
from mfbench.tests import tiny

CELL = "mf_occ.serve.pose8"
METRIC = "pose.select_kernel_pct"


def _run(trace, monkeypatch):
    """The tiny run's result and the ``harness.Run`` its readers got."""
    seen = {}
    read_metrics = harness.read_metrics

    def keep(cell, run, section):
        seen["run"] = run
        return read_metrics(cell, run, section)

    monkeypatch.setattr(harness, "read_metrics", keep)
    # a window long enough to reach the traced stretch on a loaded host
    result, _ = tiny.run_tiny(CELL, seed=2718281801, trace=trace,
                              seconds=5.0)
    return result, seen["run"]


def test_the_metric_is_listed_for_the_pose_cell():
    listed = {m["name"]: m for m in tiny.tiny_cell(CELL).per_layer}
    assert listed[METRIC]["source"] == "program_counter"
    assert listed[METRIC]["moves"] == "frames_per_s"


def test_traced_run_counts_the_frames_and_no_kernel(monkeypatch):
    result, run = _run(True, monkeypatch)
    assert result["correct"]
    frames = readers.profiled_units(run)
    rec = program_spans.recorded(run)
    assert rec["counters"]["pose_node.frames"] == len(frames)
    assert rec["counters"].get("pose_node.select_kernel", 0) == 0
    assert result["metrics"][METRIC]["value"] == pytest.approx(0.0)


def test_untraced_run_reports_no_select_kernel_pct(monkeypatch):
    result, run = _run(False, monkeypatch)
    assert result["correct"]
    assert METRIC not in result["metrics"]
    path = tiny.ROOT / "mfbench" / "layer_metrics" / f"{METRIC}.py"
    assert harness.load_module(path, METRIC).read(run) is None
