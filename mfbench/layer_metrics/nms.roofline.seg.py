"""nms.cu's share of its roofline in the traced frames: the least time of
the proposals' and detections' calls (``counts_maskrcnn.nms_work``: every
IoU pair, the boxes read once, the bitmask and the flags written once)
over the device time of its two kernels."""

from mfbench import counts_maskrcnn


def read(run):
    return counts_maskrcnn.roofline(
        run, ("nms_mask_kernel", "nms_scan_kernel"), "nms")
