"""Median interval on the device of the pose node's crop, forward and
readout (the span ``pose_node.predict``) in the traced frames."""

from mfbench import program_spans


def read(run):
    return program_spans.device_ms_p50(run, "pose_node.predict")
