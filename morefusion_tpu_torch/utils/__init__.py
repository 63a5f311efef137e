"""Host utilities of the port (``morefusion_tpu.utils``)."""

# flake8: noqa: F401

from .provenance import get_data_path
from .provenance import githash
