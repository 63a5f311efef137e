"""Serving nodes of the port (``morefusion_tpu.runtime``)."""

from .pose_estimation import PoseEstimationNode  # noqa: F401
