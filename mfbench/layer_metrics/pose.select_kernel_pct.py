"""Share of the traced frames whose instances' boxes and finite points came
from the port's CUDA kernel (``ops/instance_boxes.py``): 100 x the counter
``pose_node.select_kernel`` over ``pose_node.frames``."""

from mfbench import program_spans


def read(run):
    return program_spans.counter_pct(run, "pose_node.select_kernel",
                                     "pose_node.frames")
