"""Median interval on the device of SingleView3D's voxel branch in the
forward (the span ``model.voxel``: point convs, voxelization, occupancy
convs, conv3 / conv4 and the interpolations) in the traced stretch."""

from mfbench import program_spans


def read(run):
    return program_spans.device_ms_p50(run, "model.voxel")
