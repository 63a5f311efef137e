"""Host utilities of the port (``morefusion_tpu.utils``)."""

# flake8: noqa: F401

from .profiling import StepTimer
from .profiling import annotate
from .profiling import trace
from .provenance import get_data_path
from .provenance import githash
from .timer import timer
