"""min_dist.cu's share of its roofline in the train step's traced stretch."""

from mfbench import readers


def read(run):
    return readers.kernel_roofline(run, "min_dist")
