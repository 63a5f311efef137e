"""Pose-estimation node: instance crops -> SingleView3D -> best poses (+ICP).

Port of ``morefusion_tpu/runtime/pose_estimation.py``. Per frame, the host
ships one RGB frame, one organized cloud, the instance label image and the
instances' no-entry grids in one copy; the instances' boxes and finite
points (``ops/instance_boxes.py``), cropping, the forward and the
best-confidence readout run on the device, and the host reads back only the
boxes' small table before the forward and the poses after it. With
``with_icp=True``, :meth:`PoseEstimationNode.resolve` then refines each
pose by ICP against the instance's observed points, one object at a time,
as the JAX node does. The model computes in its own
``compute_dtype`` (fp32 or bf16); the crops, the poses, the confidences and
ICP stay fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..contrib.icp import ICPRegistration
from ..functions.transforms import transformation_matrix
from ..ops.instance_boxes import instance_boxes
from ..utils.profiling import annotate, count

_ALIGN = 256  # bytes between the parts of a staging buffer
_TORCH_DTYPES = {np.uint8: torch.uint8, np.int32: torch.int32,
                 np.int64: torch.int64, np.float32: torch.float32}


def _views(buf, parts, offsets):
    """Each part (numpy dtype, shape) of the uint8 array or tensor ``buf``
    at its byte offset."""
    out = []
    for (d, shape), o in zip(parts, offsets):
        part = buf[o:o + d.itemsize * math.prod(shape)]
        if isinstance(part, np.ndarray):
            out.append(part.view(d).reshape(shape))
        else:
            out.append(part.view(_TORCH_DTYPES[d.type]).reshape(shape))
    return out


class _Stage:
    """One of the node's copies to the device, laid out in parts (each at a
    multiple of ``_ALIGN`` bytes) that the host fills through numpy views.

    On a card the host buffer is pinned, reused from frame to frame and
    grown when a frame needs more room; each frame's copy runs on the
    node's ``stream`` into a device buffer allocated there, which the
    caching allocator reuses once the current stream is done with it. On
    the CPU the buffer is the device's input itself, so each frame takes a
    new one.
    """

    def __init__(self, device, stream):
        self._device, self._stream = device, stream
        self._host = self._sent = None

    def layout(self, parts):
        """Lay ``parts`` (numpy dtype, shape) out; a numpy view of each."""
        self._parts = [(np.dtype(d), tuple(s)) for d, s in parts]
        self._offsets, n = [], 0
        for d, shape in self._parts:
            n = -(-n // _ALIGN) * _ALIGN
            self._offsets.append(n)
            n += d.itemsize * math.prod(shape)
        self._nbytes = n
        if self._sent is not None:
            self._sent.synchronize()  # the last copy has left the buffer
        if self._stream is None or self._host is None \
                or self._host.numel() < n:
            self._host = torch.empty(n, dtype=torch.uint8,
                                     pin_memory=self._stream is not None)
        return _views(self._host.numpy(), self._parts, self._offsets)

    def send(self, wait: bool = False):
        """The parts on the device: views of the buffer itself on the CPU;
        on a card, views of the copy (with ``wait``, the current stream
        waits for it there)."""
        if self._stream is None:
            return _views(self._host, self._parts, self._offsets)
        main = torch.cuda.current_stream(self._device)
        with torch.cuda.stream(self._stream):
            buf = torch.empty(self._nbytes, dtype=torch.uint8,
                              device=self._device)
            buf.copy_(self._host[:self._nbytes], non_blocking=True)
            self._sent = torch.cuda.Event()
            self._sent.record()
        buf.record_stream(main)
        if wait:
            main.wait_event(self._sent)
        return _views(buf, self._parts, self._offsets)


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
        on_card = self._device.type == "cuda"
        # the node's own stream on a card: uploads, the boxes, read-back
        self._stream = torch.cuda.Stream(self._device) if on_card else None
        # the frame, its ids and grids; each lane's instance and scalars
        self._frame = _Stage(self._device, self._stream)
        self._lanes = _Stage(self._device, self._stream)

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
        """Enqueue the frame's pose stage on the device; :meth:`resolve`
        reads the result back.

        The frame, the instance ids and their no-entry grids go to the
        device in one copy from a staging buffer the node reuses; there
        ``ops/instance_boxes.py`` gives each instance's box and finite
        points in one pass, and the node poses those with a finite point,
        in ``instance_to_class``'s order. On a card the copies, the kernel
        and the read-back of its small result run on the node's own stream,
        so this waits for them and not for work queued earlier on the
        current stream; the current stream waits for them before the crop.
        """
        cands = list(instance_to_class)
        if not cands:
            return None
        count("pose_node.frames")
        H, W = instance_label.shape
        K, V = len(cands), self._voxel_dim
        # room for a power of two of instances: frames of 5-8 share a layout
        room = 1 << (K - 1).bit_length()
        with annotate("pose_node.upload"):
            if rgb.dtype != np.uint8:
                rgb = np.clip(rgb, 0, 255).astype(np.uint8)
            rgb_h, pcd_h, label_h, ids_h, grids_h = self._frame.layout([
                (np.uint8, (H, W, 3)), (np.float32, (H, W, 3)),
                (np.int32, (H, W)), (np.int32, (room,)),
                (np.uint8, (room, V, V, V))])
            np.copyto(rgb_h, rgb)
            np.copyto(pcd_h, pcd, casting="unsafe")
            np.copyto(label_h, instance_label, casting="unsafe")
            ids_h[:K] = cands
            for k, ins_id in enumerate(cands):
                g = None if noentry_grids is None else noentry_grids.get(
                    ins_id)
                if g is None:
                    grids_h[k] = 0
                elif g.dtype != np.uint8:
                    grids_h[k] = (np.clip(g, 0.0, 1.0) * 255.0).round()
                else:
                    grids_h[k] = g
            rgb_d, pcd_d, label_d, ids_d, grids_d = self._frame.send()
        with annotate("pose_node.select"):
            boxes_d, boxes = self._instance_boxes(label_d, pcd_d, ids_d[:K])
            keep = np.flatnonzero(boxes[:, 4] > 0)
            if not len(keep):
                return None
            ids = [cands[k] for k in keep]
            class_ids = [instance_to_class[i] for i in ids]
            B = len(ids)
            take = list(range(B)) + [0] * ((1 << (B - 1).bit_length()) - B)
            L = len(take)
            parts = [(np.int64, (L,)), (np.int64, (L,)), (np.float32, (L,))]
            if sample_indices is not None:
                n = len(sample_indices[ids[0]])
                parts.append((np.int64, (L, n)))
            lanes_h = self._lanes.layout(parts)
            lanes_h[0][:] = keep[take]
            lanes_h[1][:] = [class_ids[k] for k in take]
            lanes_h[2][:] = [self._voxel_pitch(V, class_ids[k]) for k in take]
            if sample_indices is not None:
                for j, k in enumerate(take):
                    np.copyto(lanes_h[3][j], sample_indices[ids[k]],
                              casting="unsafe")
            lane_d, class_d, pitch_d, *idx_d = self._lanes.send(wait=True)
        count("pose_node.instances", B)
        count("pose_node.lanes", L)
        with annotate("pose_node.predict"):
            with torch.inference_mode():
                T, conf = self._predict_frame(
                    rgb_d, pcd_d, label_d, ids_d[lane_d],
                    boxes_d[lane_d, :4], class_d, pitch_d, grids_d[lane_d],
                    idx_d[0] if idx_d else None)
                # one read-back in resolve: T's 16 entries and conf a lane
                out = torch.cat([T.reshape(L, 16), conf[:, None]], 1)
        return dict(out=out, ids=ids, class_ids=class_ids, B=B,
                    pcd=pcd, instance_label=instance_label)

    def _instance_boxes(self, label, pcd, ids):
        """``ops/instance_boxes.py`` on the device's frame: the result on
        the device and on the host. On a card it runs on the node's stream,
        and this waits for that stream alone."""
        if self._stream is None:
            boxes = instance_boxes(label, pcd, ids)
            return boxes, boxes.numpy()
        main = torch.cuda.current_stream(self._device)
        host = torch.empty((ids.shape[0], 5), dtype=torch.int32,
                           pin_memory=True)
        launches = instance_boxes.launches
        with torch.cuda.stream(self._stream):
            boxes = instance_boxes(label, pcd, ids)
            host.copy_(boxes, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        if instance_boxes.launches > launches:
            count("pose_node.select_kernel")
        done.synchronize()
        boxes.record_stream(main)
        return boxes, host.numpy()

    def resolve(self, handle: Optional[dict]) -> Dict[int, dict]:
        """Read back a dispatched frame's poses; with ICP, refine each pose
        whose instance has more than 10 finite points."""
        self.last_icp_iterations = {}
        if handle is None:
            return {}
        with annotate("pose_node.resolve"):
            B = handle["B"]
            out = handle["out"].cpu().numpy()[:B]
            Ts = out[:, :16].reshape(B, 4, 4).astype(np.float64)
            confs = out[:, 16]
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
