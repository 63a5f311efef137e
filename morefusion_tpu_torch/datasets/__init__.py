"""Host-side model banks of the port (numpy only)."""

# flake8: noqa: F401

from .base import ModelsBase
from .base import VoxelGrid
from .procedural import ProceduralModels
