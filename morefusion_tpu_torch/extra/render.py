"""Z-buffered point-splat renderer for synthetic RGB-D frames.

Own copy of ``morefusion_tpu/extra/render.py`` (NumPy). It replaces the
reference's pybullet offscreen renderer
(``morefusion/extra/_pybullet.py:189-288``): objects are dense surface
point samples of analytic SDF shapes; rendering is a vectorized z-buffer
splat (smallest depth wins per pixel, square splats close the holes),
followed by a morphological fill. Produces the rgb / depth / instance-label
triplet the dataset factory and visibility computation need.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def splat_render(
    points_cam: np.ndarray,
    attrs: Dict[str, np.ndarray],
    K: np.ndarray,
    shape: Tuple[int, int],
    splat: int = 1,
    znear: float = 1e-3,
):
    """Render attribute buffers by splatting camera-frame points.

    Args:
      points_cam: ``(N, 3)``.
      attrs: name -> ``(N, ...)`` per-point attributes to rasterize.
      K: ``(3, 3)`` intrinsics.
      shape: ``(H, W)``.
      splat: square splat half-width in pixels.

    Returns:
      (depth ``(H, W)`` float32 with NaN holes, buffers dict of
      ``(H, W, ...)`` arrays, zero-initialized).
    """
    H, W = shape
    z = points_cam[:, 2]
    keep = z > znear
    pts = points_cam[keep]
    z = z[keep]
    u = np.round(pts[:, 0] / z * K[0, 0] + K[0, 2]).astype(np.int64)
    v = np.round(pts[:, 1] / z * K[1, 1] + K[1, 2]).astype(np.int64)

    # Far-to-near ordering: the last write per pixel is the nearest point.
    order = np.argsort(-z, kind="stable")
    u, v, z = u[order], v[order], z[order]

    depth = np.full(H * W, np.inf, dtype=np.float32)
    sorted_attrs = {}
    buffers = {}
    for name, a in attrs.items():
        a = a[keep][order]
        sorted_attrs[name] = a
        buffers[name] = np.zeros((H * W,) + a.shape[1:], dtype=a.dtype)

    offsets = range(-splat, splat + 1)
    for dv in offsets:
        for du in offsets:
            uu, vv = u + du, v + dv
            ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            pix = vv[ok] * W + uu[ok]
            zz = z[ok]
            # last-write-wins == nearest, but only overwrite when nearer
            # than what's already there from earlier splat offsets
            better = zz <= depth[pix]
            pix_b = pix[better]
            depth[pix_b] = zz[better]
            for name, a in sorted_attrs.items():
                buffers[name][pix_b] = a[ok][better]

    depth[np.isinf(depth)] = np.nan
    depth = depth.reshape(H, W)
    buffers = {
        k: v.reshape((H, W) + v.shape[1:]) for k, v in buffers.items()
    }
    return depth, buffers


def render_scene(
    models,
    class_ids: Sequence[int],
    Ts_cad2cam: Sequence[np.ndarray],
    K: np.ndarray,
    shape: Tuple[int, int],
    instance_ids: Optional[Sequence[int]] = None,
    n_points_per_object: int = 30000,
    splat: int = 1,
    light_dir=(0.3, -0.5, -0.8),
):
    """Render a scene of posed objects.

    Args:
      models: a ``ProceduralModels``-like bank (needs ``get_shape``,
        ``get_color``).
      class_ids: per-instance class ids (1-based).
      Ts_cad2cam: per-instance ``(4, 4)`` poses.
      instance_ids: labels written into the instance image (default
        ``0..n-1``); background pixels are ``-1``.

    Returns:
      dict with ``rgb (H, W, 3) uint8``, ``depth (H, W) float32`` (NaN =
      background), ``instance_label (H, W) int32``.
    """
    if instance_ids is None:
        instance_ids = list(range(len(class_ids)))

    all_pts, all_rgb, all_ins = [], [], []
    light = np.asarray(light_dir, dtype=np.float64)
    light /= np.linalg.norm(light)

    for ins_id, cid, T in zip(instance_ids, class_ids, Ts_cad2cam):
        if hasattr(models, "get_surface_samples"):
            pts, normals = models.get_surface_samples(
                int(cid), n_points_per_object
            )
        else:
            shape_obj = models.get_shape(cid)
            rng = np.random.RandomState(int(cid) * 7919 + 13)
            pts = shape_obj.sample_surface(n_points_per_object, rng)
            normals = shape_obj.normals(pts)
        pts_cam = pts @ T[:3, :3].T + T[:3, 3]
        n_cam = normals @ T[:3, :3].T
        shade = 0.45 + 0.55 * np.clip(-(n_cam @ light), 0.0, 1.0)
        base = models.get_color(cid).astype(np.float64)[None, :]
        rgb = np.clip(shade[:, None] * base, 0, 255).astype(np.uint8)

        all_pts.append(pts_cam)
        all_rgb.append(rgb)
        all_ins.append(np.full(len(pts_cam), ins_id, dtype=np.int32))

    if not all_pts:
        H, W = shape
        return dict(
            rgb=np.zeros((H, W, 3), np.uint8),
            depth=np.full((H, W), np.nan, np.float32),
            instance_label=np.full((H, W), -1, np.int32),
        )

    pts = np.concatenate(all_pts)
    attrs = {
        "rgb": np.concatenate(all_rgb),
        "ins": np.concatenate(all_ins) + 1,  # 0 = background sentinel
    }
    depth, buf = splat_render(pts, attrs, K, shape, splat=splat)
    instance_label = buf["ins"].astype(np.int32) - 1
    return dict(rgb=buf["rgb"], depth=depth, instance_label=instance_label)
