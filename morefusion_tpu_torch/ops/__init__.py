"""Hand-written CUDA kernels of the port, each beside its plain version."""

from .min_dist import min_dist_voxels, min_dist_voxels_plain  # noqa: F401
