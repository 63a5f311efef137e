"""Median interval on the device of the train step's forward (the span
``trainer.forward``) in the traced stretch."""

from mfbench import program_spans


def read(run):
    return program_spans.device_ms_p50(run, "trainer.forward")
