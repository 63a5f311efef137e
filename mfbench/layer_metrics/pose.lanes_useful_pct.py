"""Share of the pose node's batch lanes that hold a real instance in the
traced frames: 100 x the counter ``pose_node.instances`` over
``pose_node.lanes`` (the padded buckets)."""

from mfbench import program_spans


def read(run):
    return program_spans.counter_pct(run, "pose_node.instances",
                                     "pose_node.lanes")
