"""NumPy host geometry of the port, kept as its own copies.

Copies of ``morefusion_tpu/geometry``, in modules of the same names.
Quaternions are ``(w, x, y, z)``. ``nn`` is the port's
``functions.knn.nn`` (the knn kernel on the card, its plain version on
the CPU), batched over a leading lane axis.
"""

# flake8: noqa: F401

from ..functions.knn import nn
from . import trajectory
from .bbox import get_aabb_from_points
from .bbox import masks_to_bboxes
from .cameras import from_opengl_transform
from .cameras import look_at
from .cameras import points_from_angles
from .cameras import project_to_camera
from .cameras import to_opengl_transform
from .cameras import uniform_points_on_sphere
from .pointcloud import estimate_pointcloud_normals
from .pointcloud import pointcloud_from_depth
from .pointcloud import voxel_down_sample
from .transform import compose_transform
from .transform import quaternion_from_matrix
from .transform import quaternion_matrix_np
from .transform import transform_points_np
from .transform import translation_from_matrix
from .voxel_mapping import VoxelMapping
