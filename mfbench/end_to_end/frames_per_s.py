"""Frames whose results reached the host, over the window seconds."""

from mfbench import readers


def read(run):
    return readers.per_second(run)
