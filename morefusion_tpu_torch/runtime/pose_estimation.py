"""Pose-estimation node: instance crops -> SingleView3D -> best poses (+ICP).

Port of ``morefusion_tpu/runtime/pose_estimation.py``. Per frame, the host
ships one RGB frame, one organized cloud, the instance label image and
per-instance scalars; cropping, the forward and the best-confidence readout
run on the device. With ``with_icp=True``, :meth:`PoseEstimationNode.resolve`
then refines each pose by ICP against the instance's observed points, one
object at a time, as the JAX node does. The model computes in its own
``compute_dtype`` (fp32 or bf16); the crops, the poses, the confidences and
ICP stay fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..contrib.icp import ICPRegistration
from ..functions.transforms import transformation_matrix
from ..geometry import masks_to_bboxes
from ..utils.profiling import annotate, count


def _crop_instance_device(rgb_frame, pcd_frame, label, ins_ids, bboxes,
                          image_size: int):
    """Mask, crop and centre each instance at ``image_size``^2 on the device.

    ``rgb_frame (H, W, 3)``, ``pcd_frame (H, W, 3)``, ``label (H, W)``,
    ``ins_ids (B,)``, ``bboxes (B, 4)`` as ``(y1, x1, y2, x2)`` ->
    ``rgb (B, S, S, 3)`` float32 and ``pcd (B, S, S, 3)`` (NaN off the
    instance). The resize keeps the aspect ratio and pads at the centre with
    cv2's conventions: INTER_LINEAR for rgb, whose off-mask pixels count as
    0, and INTER_NEAREST for the cloud.
    """
    S = image_size
    device = rgb_frame.device
    y1, x1, y2, x2 = bboxes.to(torch.int64).unbind(dim=1)
    ins = ins_ids[:, None, None]
    Hb = (y2 - y1).to(torch.float32)
    Wb = (x2 - x1).to(torch.float32)
    scale = torch.minimum(S / Hb, S / Wb)
    h = torch.clamp(torch.round(Hb * scale), 1, S).to(torch.int64)
    w = torch.clamp(torch.round(Wb * scale), 1, S).to(torch.int64)
    y0 = torch.div(S - h, 2, rounding_mode="floor")
    x0 = torch.div(S - w, 2, rounding_mode="floor")
    ys = torch.arange(S, device=device)
    vy = (ys >= y0[:, None]) & (ys < (y0 + h)[:, None])  # (B, S)
    vx = (ys >= x0[:, None]) & (ys < (x0 + w)[:, None])
    valid = vy[:, :, None] & vx[:, None, :]  # (B, S, S)
    ry = (Hb / h)[:, None]
    rx = (Wb / w)[:, None]

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo[:, None]), hi[:, None])

    # nearest: src = floor(dst * src/dst), clamped to the bbox
    sy = clip(y1[:, None] + torch.floor((ys - y0[:, None]) * ry).long(),
              y1, y2 - 1)
    sx = clip(x1[:, None] + torch.floor((ys - x0[:, None]) * rx).long(),
              x1, x2 - 1)
    mask = (label[sy[:, :, None], sx[:, None, :]] == ins) & valid
    pcd_c = pcd_frame[sy[:, :, None], sx[:, None, :]]
    pcd_c = torch.where(mask[..., None], pcd_c, float("nan"))

    # bilinear: fsrc = (dst + 0.5) * src/dst - 0.5; a corner off the
    # instance mask contributes 0
    ysf = ys.to(torch.float32)
    fy = (ysf - y0[:, None] + 0.5) * ry - 0.5
    fx = (ysf - x0[:, None] + 0.5) * rx - 0.5
    zero = torch.zeros_like(Hb)
    fy = clip(fy, zero, Hb - 1.0) + y1[:, None]
    fx = clip(fx, zero, Wb - 1.0) + x1[:, None]
    fy0, fx0 = torch.floor(fy), torch.floor(fx)
    wy = (fy - fy0)[:, :, None]
    wx = (fx - fx0)[:, None, :]
    iy0, ix0 = fy0.long(), fx0.long()
    iy1 = torch.minimum(iy0 + 1, (y2 - 1)[:, None])
    ix1 = torch.minimum(ix0 + 1, (x2 - 1)[:, None])

    def corner(iy, ix):
        r = rgb_frame[iy[:, :, None], ix[:, None, :]].to(torch.float32)
        m = label[iy[:, :, None], ix[:, None, :]] == ins
        return r * m[..., None]

    rgb_c = (
        corner(iy0, ix0) * ((1 - wy) * (1 - wx))[..., None]
        + corner(iy0, ix1) * ((1 - wy) * wx)[..., None]
        + corner(iy1, ix0) * (wy * (1 - wx))[..., None]
        + corner(iy1, ix1) * (wy * wx)[..., None]
    )
    return rgb_c * valid[..., None], pcd_c


class PoseEstimationNode:
    """Instance-segmented RGB-D frame -> one pose per instance.

    ``model`` is a port ``SingleView3D`` with its weights loaded;
    ``voxel_pitch(voxel_dim, class_id)`` gives each class's voxel size (a
    models bank's ``get_voxel_pitch``). The instance batch is padded to a
    power of two with copies of the first instance. With ``with_icp=True``,
    ``cad_points(class_id)`` gives each class's CAD points (a models bank's
    ``get_pcd``), where the JAX node reads both from its ``models``; after
    each frame ``last_icp_iterations`` maps each refined instance to its ICP
    iterations.
    """

    def __init__(
        self,
        model,
        voxel_pitch: Callable[[int, int], float],
        image_size: int = 256,
        voxel_dim: int = 32,
        device="cuda",
        with_icp: bool = False,
        cad_points: Optional[Callable[[int], np.ndarray]] = None,
    ):
        if with_icp and cad_points is None:
            raise ValueError("with_icp=True needs cad_points")
        self._device = torch.device(device)
        self._model = model.to(self._device).eval()
        self._voxel_pitch = voxel_pitch
        self._image_size = image_size
        self._voxel_dim = voxel_dim
        self._with_icp = with_icp
        self._cad_points = cad_points
        self.last_icp_iterations = {}

    @torch.inference_mode()
    def _predict_frame(self, rgb, pcd, label, ins_ids, bboxes, class_ids,
                       pitches, grids_u8, sample_indices):
        rgb_c, pcd_c = _crop_instance_device(
            rgb, pcd, label, ins_ids, bboxes, self._image_size)
        kw = dict(class_id=class_ids, rgb=rgb_c, pcd=pcd_c, pitch=pitches)
        if self._model.with_occupancy:
            kw["grid_nontarget_empty"] = grids_u8.to(torch.float32) / 255.0
        if sample_indices is None:
            # a fixed seed per frame, as the JAX package's eval key
            kw["generator"] = torch.Generator(
                device=self._device).manual_seed(1234)
        quat, trans, conf = self._model(**kw, sample_indices=sample_indices)
        best = torch.argmax(conf, dim=1)
        bidx = torch.arange(conf.shape[0], device=self._device)
        T = transformation_matrix(quat[bidx, best], trans[bidx, best])
        return T, conf[bidx, best]

    def estimate(
        self,
        rgb: np.ndarray,
        pcd: np.ndarray,
        instance_label: np.ndarray,
        instance_to_class: Dict[int, int],
        noentry_grids: Optional[Dict[int, np.ndarray]] = None,
        sample_indices: Optional[Dict[int, np.ndarray]] = None,
    ) -> Dict[int, dict]:
        """Returns ``{instance_id: {'T_cad2cam', 'class_id', 'confidence'}}``.

        ``sample_indices`` optionally fixes each instance's ``n_point`` flat
        pixel indices into its crop; by default they are drawn on the device
        from a generator seeded with 1234.
        """
        handle = self.dispatch(rgb, pcd, instance_label, instance_to_class,
                               noentry_grids, sample_indices)
        return self.resolve(handle)

    def dispatch(
        self,
        rgb: np.ndarray,
        pcd: np.ndarray,
        instance_label: np.ndarray,
        instance_to_class: Dict[int, int],
        noentry_grids: Optional[Dict[int, np.ndarray]] = None,
        sample_indices: Optional[Dict[int, np.ndarray]] = None,
    ) -> Optional[dict]:
        """Enqueue the frame's pose stage on the device without waiting for
        it; :meth:`resolve` reads the result back."""
        with annotate("pose_node.select"):
            finite = ~np.isnan(pcd).any(axis=2)
            V = self._voxel_dim
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
                pitches.append(self._voxel_pitch(V, class_id))
                g = (None if noentry_grids is None
                     else noentry_grids.get(ins_id))
                if g is None:
                    g = np.zeros((V, V, V), np.uint8)
                elif g.dtype != np.uint8:
                    g = (np.clip(g, 0.0, 1.0) * 255.0).round().astype(
                        np.uint8)
                grids.append(g)
            if not ids:
                return None
        B = len(ids)
        take = list(range(B)) + [0] * ((1 << (B - 1).bit_length()) - B)
        count("pose_node.instances", B)
        count("pose_node.lanes", len(take))
        with annotate("pose_node.upload"):
            if rgb.dtype != np.uint8:
                rgb = np.clip(rgb, 0, 255).astype(np.uint8)
            dev = self._device

            def put(a, dtype=None):
                a = np.ascontiguousarray(
                    a if dtype is None else a.astype(dtype))
                return torch.from_numpy(a).to(dev)

            idx = None
            if sample_indices is not None:
                idx = put(np.stack([sample_indices[ids[k]] for k in take]),
                          np.int64)
            inputs = (
                put(rgb),
                put(pcd, np.float32),
                put(instance_label, np.int32),
                put(np.asarray(ids, np.int32)[take]),
                put(np.asarray(bboxes, np.int64)[take]),
                put(np.asarray(class_ids, np.int64)[take]),
                put(np.asarray(pitches, np.float32)[take]),
                put(np.stack(grids)[take]),
                idx,
            )
        with annotate("pose_node.predict"):
            T, conf = self._predict_frame(*inputs)
        return dict(T=T, conf=conf, ids=ids, class_ids=class_ids, B=B,
                    pcd=pcd, instance_label=instance_label)

    def resolve(self, handle: Optional[dict]) -> Dict[int, dict]:
        """Read back a dispatched frame's poses; with ICP, refine each pose
        whose instance has more than 10 finite points."""
        self.last_icp_iterations = {}
        if handle is None:
            return {}
        with annotate("pose_node.resolve"):
            B = handle["B"]
            Ts = handle["T"].cpu().numpy().astype(np.float64)[:B]
            confs = handle["conf"].cpu().numpy()[:B]
            pcd, label = handle["pcd"], handle["instance_label"]
            results = {}
            for k, ins_id in enumerate(handle["ids"]):
                T = Ts[k]
                class_id = int(handle["class_ids"][k])
                if self._with_icp:
                    depth_points = pcd[(label == ins_id)
                                       & ~np.isnan(pcd).any(axis=2)]
                    if len(depth_points) > 10:
                        reg = ICPRegistration(depth_points,
                                              self._cad_points(class_id), T,
                                              device=self._device)
                        T = reg.register()
                        self.last_icp_iterations[ins_id] = (
                            reg.last_n_iterations)
                results[ins_id] = dict(T_cad2cam=T, class_id=class_id,
                                       confidence=float(confs[k]))
            return results
