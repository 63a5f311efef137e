"""Synthetic scenes of the port (NumPy), own copy of
``morefusion_tpu.simulation``."""

# flake8: noqa: F401

from .scene_generation import BinTypeSceneGeneration
from .scene_generation import PlaneTypeSceneGeneration
from .scene_generation import SceneGenerationBase
