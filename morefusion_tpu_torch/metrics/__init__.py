"""Evaluation metrics of the port (``morefusion_tpu.metrics``): ADD / ADD-S
and the YCB-Video VOCap AUC, NumPy in and NumPy out."""

# flake8: noqa: F401

from .auc import auc_for_errors
from .auc import ycb_video_add_auc
from .average_distance import average_distance
