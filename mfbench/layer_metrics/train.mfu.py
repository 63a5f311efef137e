"""The train step's FLOPs (the count of ``drivers/train_step.py::step_flops``)
x steps over the window's seconds, outside the traced stretch, against the
H100's fp32 peak (TF32 is off)."""

from mfbench import readers


def read(run):
    count = run.record.extra.get("step_flops")
    if count is None or not run.record.units:
        return None
    flops = count()
    return readers.steady_mfu(run, lambda u: flops)
