"""The frames' dense FLOPs (``counts_maskrcnn.frame_flops``: ResNet-50, FPN,
RPN head and the box head on the proposals, with the mask head a
detection the node kept) over the window's seconds, outside the traced
stretch, against the H100's fp32 peak (TF32 is off)."""

from mfbench import readers


def read(run):
    count = run.record.extra.get("frame_flops")
    if count is None or not run.record.units:
        return None
    fixed, per_detection = count()
    return readers.steady_mfu(
        run, lambda u: fixed + per_detection * u["instances"]
        if u.get("ok", True) else 0)
