"""Median host time of the pose node's uploads (the span
``pose_node.upload``) in the traced frames."""

from mfbench import program_spans


def read(run):
    return program_spans.host_ms_p50(run, "pose_node.upload")
