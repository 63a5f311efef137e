"""Median host time of the pose node's per-instance masks, boxes, pitches
and grids (the span ``pose_node.select``) in the traced frames."""

from mfbench import program_spans


def read(run):
    return program_spans.host_ms_p50(run, "pose_node.select")
