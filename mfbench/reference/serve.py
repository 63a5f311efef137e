"""The pose node's frame and ICC's refine in plain PyTorch.

``predict_frame`` is a frozen copy of ``morefusion_tpu_torch/runtime/
pose_estimation.py::PoseEstimationNode.dispatch`` and ``_predict_frame``,
returning every sampled point's pose and confidence of each instance
rather than the best one alone: the same instance order and filtering, the
same bounding boxes, the batch padded to a power of two with copies of the
first instance, the device crop, the forward with its points drawn from a
generator seeded with 1234 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .contrib.collision_refine import IterativeCollisionCheck
from .functions.transforms import transformation_matrix
from .runtime.crop import _crop_instance_device, masks_to_bboxes

SAMPLE_SEED = 1234  # the node's fixed sampling seed a frame


def predict_frame(model, voxel_pitch, rgb, pcd, instance_label,
                  instance_to_class, noentry_grids, image_size, voxel_dim):
    """``{instance id: (T (P, 4, 4), conf (P,))}`` on the host (float64),
    for every instance the node would pose."""
    device = next(model.parameters()).device
    finite = ~np.isnan(pcd).any(axis=2)
    V = voxel_dim
    ids, bboxes, class_ids, pitches, grids = [], [], [], [], []
    for ins_id, class_id in instance_to_class.items():
        mask = instance_label == ins_id
        if not (mask & finite).any():
            continue
        y1, x1, y2, x2 = masks_to_bboxes(mask).round().astype(int)
        if (y2 - y1) * (x2 - x1) == 0:
            continue
        ids.append(ins_id)
        bboxes.append((y1, x1, y2, x2))
        class_ids.append(class_id)
        pitches.append(voxel_pitch(V, class_id))
        g = noentry_grids.get(ins_id)
        grids.append(np.zeros((V, V, V), np.uint8) if g is None else g)
    if not ids:
        return {}
    B = len(ids)
    take = list(range(B)) + [0] * ((1 << (B - 1).bit_length()) - B)

    def put(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a).to(device)

    with torch.inference_mode():
        rgb_c, pcd_c = _crop_instance_device(
            put(rgb), put(pcd, np.float32), put(instance_label, np.int32),
            put(np.asarray(ids, np.int32)[take]),
            put(np.asarray(bboxes, np.int64)[take]), image_size)
        kw = dict(class_id=put(np.asarray(class_ids, np.int64)[take]),
                  rgb=rgb_c, pcd=pcd_c,
                  pitch=put(np.asarray(pitches, np.float32)[take]))
        if model.with_occupancy:
            kw["grid_nontarget_empty"] = (
                put(np.stack(grids)[take]).to(torch.float32) / 255.0)
        generator = torch.Generator(device=device).manual_seed(SAMPLE_SEED)
        quat, trans, conf = model(**kw, generator=generator)
        T = transformation_matrix(quat, trans)
    T = T[:B].double().cpu().numpy()
    conf = conf[:B].double().cpu().numpy()
    return {ins: (T[k], conf[k]) for k, ins in enumerate(ids)}


def collision_check(transforms, points, sdf, pitch, origin, target,
                    noentry, voxel_dim, max_points, device):
    """ICC's problem from ``transforms``: ``refine`` gives the refined
    poses, ``loss_components(T)`` the objective at the poses ``T``."""
    return IterativeCollisionCheck(
        transforms, points, sdf, pitch, origin, target, noentry,
        voxel_dim=voxel_dim, max_points=max_points, device=device)
