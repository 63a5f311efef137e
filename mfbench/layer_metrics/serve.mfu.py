"""The forward FLOPs of the frames' real instances (the batch's padding not
counted) over the window's seconds, outside the traced stretch, against the
H100's fp32 peak (TF32 is off)."""

from mfbench import readers


def read(run):
    count = run.record.extra.get("instance_flops")
    if count is None or not run.record.units:
        return None
    flops = count()
    return readers.steady_mfu(
        run, lambda u: flops * u["instances"] if u.get("ok", True) else 0)
