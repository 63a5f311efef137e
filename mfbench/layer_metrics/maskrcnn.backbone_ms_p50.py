"""Median interval on the device of Mask R-CNN's ResNet-50 and FPN (the
span ``maskrcnn.backbone``) in the traced frames."""

from mfbench import program_spans


def read(run):
    return program_spans.device_ms_p50(run, "maskrcnn.backbone")
