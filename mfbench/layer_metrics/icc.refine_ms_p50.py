"""Median host-clock time of ``IterativeCollisionCheck.refine`` a frame."""

from mfbench import readers


def read(run):
    return readers.span_ms_p50(run, "icc.refine")
