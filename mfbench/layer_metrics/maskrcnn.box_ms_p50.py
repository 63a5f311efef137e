"""Median interval on the device of Mask R-CNN's box stage (RoIAlign 7x7,
the box head, the detections' selection and NMS; the span
``maskrcnn.box``) in the traced frames."""

from mfbench import program_spans


def read(run):
    return program_spans.device_ms_p50(run, "maskrcnn.box")
