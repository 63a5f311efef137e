"""Kernel launches inside the program's ``trainer.step`` spans of the traced
stretch, per step."""

from mfbench import program_spans


def read(run):
    return program_spans.launches_per_span(run, "trainer.step")
