"""Median host-clock time of ``PoseEstimationNode.estimate`` a frame."""

from mfbench import readers


def read(run):
    return readers.span_ms_p50(run, "pose.estimate")
