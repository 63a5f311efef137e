"""NumPy host geometry of the port, kept as its own copies.

Copies of the parts of ``morefusion_tpu/geometry`` the port uses, in
modules of the same names. Quaternions are ``(w, x, y, z)``.
"""

# flake8: noqa: F401

from . import trajectory
from .bbox import masks_to_bboxes
from .cameras import look_at
from .cameras import points_from_angles
from .pointcloud import pointcloud_from_depth
from .pointcloud import voxel_down_sample
from .transform import compose_transform
from .transform import quaternion_from_matrix
from .transform import quaternion_matrix_np
from .transform import transform_points_np
from .transform import translation_from_matrix
