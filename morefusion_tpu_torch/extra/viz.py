"""Offscreen visualization utilities.

Own copy of ``morefusion_tpu/extra/viz.py`` (NumPy, cv2), on the port's
point-splat renderer. ``save_image`` writes with imageio, or with cv2
where imageio is not installed: the same pixels.

Replaces the reference's pyglet/trimesh interactive viewer stack
(``extra/_trimesh/display_scenes.py``) and the RViz marker nodes
(``voxel_grids_to_markers.py``, ``draw_instance_segmentation.py``) with
headless image/mesh outputs: instance overlays, predicted-pose overlays
(via the point-splat renderer), voxel-grid meshes, OBJ export.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .render import render_scene

_PALETTE = np.array(
    [
        [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
        [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
        [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    ],
    dtype=np.uint8,
)


def colorize_label(label: np.ndarray) -> np.ndarray:
    """Instance/class label image -> RGB (negative labels = black)."""
    out = np.zeros(label.shape + (3,), np.uint8)
    for k in np.unique(label):
        if k < 0:
            continue
        out[label == k] = _PALETTE[int(k) % len(_PALETTE)]
    return out


def draw_instance_segmentation(
    rgb: np.ndarray, label: np.ndarray, alpha: float = 0.5
) -> np.ndarray:
    """Blend instance colors over the image (reference
    ``draw_instance_segmentation`` node role)."""
    colors = colorize_label(label)
    mask = (label >= 0)[..., None]
    out = rgb.astype(np.float32)
    out = np.where(
        mask, (1 - alpha) * out + alpha * colors.astype(np.float32), out
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_pose_overlay(
    rgb: np.ndarray,
    models,
    class_ids: Sequence[int],
    Ts_cad2cam: Sequence[np.ndarray],
    K: np.ndarray,
    alpha: float = 0.6,
    n_points_per_object: int = 10000,
) -> np.ndarray:
    """Render predicted CAD models over the camera image (the demo.py
    CAD-overlay view of the reference)."""
    H, W = rgb.shape[:2]
    rend = render_scene(
        models, list(class_ids), list(Ts_cad2cam), K, (H, W),
        n_points_per_object=n_points_per_object,
    )
    hit = (rend["instance_label"] >= 0)[..., None]
    out = rgb.astype(np.float32)
    out = np.where(
        hit, (1 - alpha) * out + alpha * rend["rgb"].astype(np.float32), out
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def tile_images(images: Sequence[np.ndarray], cols: int = None) -> np.ndarray:
    """Tile same-size images into a grid (reference ``tile_image`` node)."""
    n = len(images)
    cols = cols or n
    rows = -(-n // cols)
    H, W = images[0].shape[:2]
    out = np.zeros((rows * H, cols * W, 3), np.uint8)
    for k, img in enumerate(images):
        r, c = divmod(k, cols)
        out[r * H : (r + 1) * H, c * W : (c + 1) * W] = img
    return out


def voxel_grid_to_mesh(
    grid: np.ndarray,
    pitch: float,
    origin,
    threshold: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Occupied voxels -> box mesh (vertices, faces).

    The reference renders voxel grids as RViz box/mesh markers
    (``voxel_grids_to_mesh_markers.py`` via marching cubes); exposed faces
    of occupied voxels give an equivalent visual without the marching-cubes
    dependency.
    """
    occ = grid > threshold
    origin = np.asarray(origin, float)
    verts, faces = [], []

    # exposed faces only
    face_dirs = [
        (np.array([1, 0, 0]), [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)]),
        (np.array([-1, 0, 0]), [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)]),
        (np.array([0, 1, 0]), [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)]),
        (np.array([0, -1, 0]), [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)]),
        (np.array([0, 0, 1]), [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]),
        (np.array([0, 0, -1]), [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)]),
    ]
    padded = np.pad(occ, 1)
    for idx in np.argwhere(occ):
        i, j, k = idx
        base = origin + idx * pitch
        for d, corners in face_dirs:
            ni, nj, nk = idx + d + 1  # padded coords
            if padded[ni, nj, nk]:
                continue  # neighbor occupied: face hidden
            v0 = len(verts)
            for c in corners:
                verts.append(base + np.asarray(c) * pitch)
            faces.append([v0, v0 + 1, v0 + 2])
            faces.append([v0, v0 + 2, v0 + 3])
    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    return np.asarray(verts), np.asarray(faces, np.int32)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def depth_to_rgb(
    depth: np.ndarray,
    min_value: Optional[float] = None,
    max_value: Optional[float] = None,
) -> np.ndarray:
    """Depth image -> turbo-ish colormap RGB (reference ``depth_to_rgb``
    node role); NaN renders black."""
    import cv2

    valid = np.isfinite(depth)
    if not valid.any():
        return np.zeros(depth.shape + (3,), np.uint8)
    lo = np.nanmin(depth) if min_value is None else min_value
    hi = np.nanmax(depth) if max_value is None else max_value
    norm = np.clip(
        np.nan_to_num(depth - lo) / max(hi - lo, 1e-9), 0, 1
    )
    u8 = (norm * 255).astype(np.uint8)
    bgr = cv2.applyColorMap(u8, cv2.COLORMAP_JET)
    rgb = bgr[:, :, ::-1].copy()
    rgb[~valid] = 0
    return rgb


def image_writer() -> str:
    """``"imageio"`` where it is installed, else ``"cv2"``."""
    try:
        import imageio.v2  # noqa: F401
    except ImportError:
        return "cv2"
    return "imageio"


def save_image(path: str, image: np.ndarray) -> None:
    """Write an RGB (or grey) uint8 image; its pixels are the same with
    either writer."""
    if image_writer() == "imageio":
        import imageio.v2 as imageio

        imageio.imwrite(path, image)
        return
    import cv2

    if image.ndim == 3 and image.shape[2] in (3, 4):  # cv2 writes BGR(A)
        image = image[..., [2, 1, 0, 3][: image.shape[2]]]
    if not cv2.imwrite(path, np.ascontiguousarray(image)):
        raise OSError(f"cv2 could not write {path}")
