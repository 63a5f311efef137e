"""90th percentile of the frames' latency, from the client's hand-over
to its results on the host, over all frames of the window."""

from mfbench import harness, readers


def read(run):
    ms = readers.unit_ms(run)
    return harness.percentile(ms, 90) if ms else None
