"""Median interval on the device of Mask R-CNN's RPN head and proposal
selection (top-k, decoding, NMS; the span ``maskrcnn.rpn``) in the traced
frames."""

from mfbench import program_spans


def read(run):
    return program_spans.device_ms_p50(run, "maskrcnn.rpn")
