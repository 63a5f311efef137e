"""min_dist.cu's share of its roofline in ICC's evaluations of the traced frames."""

from mfbench import readers


def read(run):
    return readers.kernel_roofline(run, "min_dist")
