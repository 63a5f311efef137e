"""Hand-written CUDA kernels of the port, each beside its plain version, and
the device connected components (stock PyTorch ops)."""

from .connected_components import connected_components  # noqa: F401
from .connected_components import relabel_components  # noqa: F401
from .knn import nn_indices, nn_indices_plain  # noqa: F401
from .min_dist import min_dist_voxels, min_dist_voxels_plain  # noqa: F401
from .resize import resize_bilinear, resize_bilinear_plain  # noqa: F401
