"""Share of the model's bilinear resizes that the port's CUDA kernel took
in the traced frames: 100 x the counter ``resize.kernel`` over
``resize.calls`` (``ops/resize.py``)."""

from mfbench import program_spans


def read(run):
    return program_spans.counter_pct(run, "resize.kernel", "resize.calls")
