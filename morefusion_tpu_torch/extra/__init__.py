"""Host-side helpers of the port (numpy, cv2 inside functions)."""

# flake8: noqa: F401
from . import image
from . import render
from . import sdf_primitives
from . import meshio
from . import viz
