"""Share of the traced stretch of frames with no operation on the card."""

from mfbench import readers


def read(run):
    return readers.idle_pct(run)
