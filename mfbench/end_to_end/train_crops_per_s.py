"""Crops trained over the whole window: B x steps / window seconds."""

from mfbench import readers


def read(run):
    return readers.per_second(run)
