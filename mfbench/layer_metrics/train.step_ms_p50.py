"""Median interval between the CUDA events at consecutive steps' ends."""

from mfbench import harness


def read(run):
    ms = run.record.extra.get("step_ms")
    return harness.median(ms) if ms else None
