"""Hand-written CUDA kernels of the port, each beside its plain version."""

from .knn import nn_indices, nn_indices_plain  # noqa: F401
from .min_dist import min_dist_voxels, min_dist_voxels_plain  # noqa: F401
