"""roi_align.cu's share of its roofline in the traced frames: the least
time of the box and mask calls (``counts_maskrcnn.roi_align_work``: the
union of the RoIs' footprints on each level read once, each output written
once) over the kernel's device time."""

from mfbench import counts_maskrcnn


def read(run):
    return counts_maskrcnn.roofline(run, ("roi_align_kernel",), "roi_align")
