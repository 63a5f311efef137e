"""Median interval on the device of Mask R-CNN's mask stage (RoIAlign
14x14 and the mask head on the kept detections; the span
``maskrcnn.mask``) in the traced frames."""

from mfbench import program_spans


def read(run):
    return program_spans.device_ms_p50(run, "maskrcnn.mask")
