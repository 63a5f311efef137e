"""Instance segmentation for the scene pipeline.

Port of ``morefusion_tpu/models/segmentation.py``: a compact UNet predicts
per-pixel class logits (and, with ``with_boundary``, an instance-boundary
logit), and ``SegmentationNode`` turns them into instances. With
``device_instancing=True`` the argmax, the boundary threshold and the
connected components (``ops/connected_components.py``) run on the device
and the host reads ``(class_map, comp)`` in one copy; with
``device_instancing=False`` the host recovers instances with cv2 (the
oracle). The host helpers are copies of JAX's; each imports cv2 inside,
where it needs it. NCHW inside the network; fp32 throughout (the JAX UNet
has no compute dtype).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops.connected_components import connected_components
from ..ops.connected_components import relabel_components
from .pspnet import resize_bilinear
from .resnet import normalize_rgb


class ConvBlock(nn.Module):
    """Two 3x3 convs, each followed by GroupNorm (``min(8, C)`` groups,
    epsilon 1e-6 as flax's) and a ReLU."""

    def __init__(self, in_channels, features):
        super().__init__()
        groups = min(8, features)
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.GroupNorm_0 = nn.GroupNorm(groups, features, eps=1e-6)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1)
        self.GroupNorm_1 = nn.GroupNorm(groups, features, eps=1e-6)

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class UNetSegmentation(nn.Module):
    """RGB (+ depth) -> per-pixel class logits ``(B, n_class, H, W)``
    (background included); with ``with_boundary`` also the boundary logits
    ``(B, H, W)``. ``rgb (B, H, W, 3)`` uint8-range; ``depth (B, H, W)``,
    NaN read as 0, enters as a fourth channel with ``use_depth``. H and W
    must be divisible by ``2 ** (len(widths) - 1)``."""

    def __init__(self, n_class: int = 22,
                 widths: Sequence[int] = (32, 64, 128, 256),
                 use_depth: bool = False, with_boundary: bool = False):
        super().__init__()
        self.n_class = n_class
        self.widths = tuple(widths)
        self.use_depth = use_depth
        self.with_boundary = with_boundary
        c = 4 if use_depth else 3
        blocks = []
        for w in self.widths:  # the encoder, then the bottom
            blocks.append(ConvBlock(c, w))
            c = w
        for w in reversed(self.widths[:-1]):  # the decoder, on [up, skip]
            blocks.append(ConvBlock(c + w, w))
            c = w
        for i, block in enumerate(blocks):
            self.add_module(f"ConvBlock_{i}", block)
        self.Conv_0 = nn.Conv2d(c, n_class, 1)
        if with_boundary:
            self.Conv_1 = nn.Conv2d(c, 1, 1)

    def forward(self, rgb, depth=None):
        x = normalize_rgb(rgb)
        if self.use_depth and depth is not None:
            d = torch.nan_to_num(depth.to(torch.float32))[..., None]
            x = torch.cat([x, d], dim=-1)
        x = x.permute(0, 3, 1, 2).contiguous()
        n = len(self.widths)
        skips = []
        for i in range(n - 1):
            x = getattr(self, f"ConvBlock_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, stride=2)
        x = getattr(self, f"ConvBlock_{n - 1}")(x)
        for i, skip in enumerate(reversed(skips)):
            _, _, H, W = x.shape
            x = torch.cat([resize_bilinear(x, H * 2, W * 2), skip], dim=1)
            x = getattr(self, f"ConvBlock_{n + i}")(x)
        class_logits = self.Conv_0(x)
        if not self.with_boundary:
            return class_logits
        return class_logits, self.Conv_1(x)[:, 0]


def boundary_from_instance_label(
    instance_label: np.ndarray, width: int = 2
) -> np.ndarray:
    """GT boundaries: pixels whose neighborhood spans 2+ instances.

    Computed from the instance-label image (background < 0 excluded, so
    object silhouettes against background are NOT boundaries — only
    instance-instance contact lines, which is what separates touching
    same-class objects).
    """
    import cv2

    lab = instance_label.astype(np.int32)
    fg = lab >= 0
    big = np.where(fg, lab, -1).astype(np.float32)
    k = np.ones((2 * width + 1,) * 2, np.uint8)
    # max/min of the instance id over the neighborhood, restricted to fg
    mx = cv2.dilate(np.where(fg, big, -np.inf).astype(np.float32), k)
    mn = -cv2.dilate(np.where(fg, -big, -np.inf).astype(np.float32), k)
    touch = np.isfinite(mx) & np.isfinite(mn) & (mx != mn)
    return touch & fg


def instances_from_predictions(
    class_map: np.ndarray,
    boundary: np.ndarray = None,
    min_area: int = 50,
) -> Tuple[np.ndarray, Dict[int, int]]:
    """Class map (+ predicted boundaries) -> multi-instance labels.

    Per class: connected components of (mask minus boundary pixels), each
    surviving component (>= min_area) becomes an instance; boundary-carved
    pixels are reassigned to the nearest surviving component
    (distance-transform labels). Without a boundary map this degrades to
    multi-component instancing (separated same-class objects still split).
    """
    import cv2

    H, W = class_map.shape
    instance_label = np.full((H, W), -1, np.int32)
    instance_to_class: Dict[int, int] = {}
    next_id = 0
    bnd = (
        np.zeros((H, W), bool)
        if boundary is None
        else boundary.astype(bool)
    )
    for cid in np.unique(class_map):
        if cid <= 0:
            continue
        mask = class_map == cid
        core = (mask & ~bnd).astype(np.uint8)
        n, comp = cv2.connectedComponents(core)
        keep = []
        for k in range(1, n):
            if int((comp == k).sum()) >= min_area:
                keep.append(k)
        if not keep:
            continue
        # reassign carved/boundary pixels of this class to the nearest
        # surviving core pixel's component
        core_keep = np.isin(comp, keep)
        if (mask & ~core_keep).any():
            dist, nearest = cv2.distanceTransformWithLabels(
                (~core_keep).astype(np.uint8),
                cv2.DIST_L2,
                3,
                labelType=cv2.DIST_LABEL_PIXEL,
            )
            ys, xs = np.nonzero(core_keep)
            lut = np.zeros(int(nearest.max()) + 1, np.int32)
            lut[nearest[ys, xs]] = comp[ys, xs]
            comp = np.where(core_keep, comp, lut[nearest])
        for k in keep:
            sel = mask & (comp == k)
            instance_label[sel] = next_id
            instance_to_class[next_id] = int(cid)
            next_id += 1
    return instance_label, instance_to_class


def merge_occlusion_splits(
    instance_label: np.ndarray,
    instance_to_class: Dict[int, int],
    class_map: np.ndarray,
    gap: int = 8,
    min_frac: float = 0.25,
) -> Tuple[np.ndarray, Dict[int, int]]:
    """Merge same-class instance fragments that an occluder split apart.

    Round-4 measured failure (docs/results/r4_seg_per_class.json): the
    boundary head over-splits heavily occluded instances — one object
    whose visible mask is cut in two by an occluder becomes two
    predicted instances (precision 0.769 -> 0.691, foam_brick detection
    0.53). The reference's Mask R-CNN predicts whole-instance masks and
    is immune (`examples/ycb_video/instance_segm/train_multi.py`); a
    dense class+boundary head needs this post-pass.

    Decision per same-class instance pair:

    - a splinter (< ``min_frac`` the area of the other) within ``gap``
      px of it is carve debris: merge regardless of what separates
      them (the relative minimum-component-size rule);
    - comparable-size instances that are directly ADJACENT were split
      on purpose by the boundary head (carved pixels are flooded back
      onto the cores, so a deliberate split leaves a zero-width seam):
      keep the split — scenes sample classes with replacement, touching
      duplicates occur (``simulation/scene_generation.py:325``);
    - comparable-size, non-adjacent instances whose ``gap``-dilations
      overlap merge iff the separating band (overlap minus both masks)
      is dominated by OTHER-class foreground — an occluder cut one
      object in two. A background-dominated band means genuinely
      separate objects.

    Transitive merges resolve by union-find; output ids are compacted.
    """
    fragments: Dict[int, list] = {}
    for iid, cid in instance_to_class.items():
        fragments.setdefault(cid, []).append(iid)

    parent = {iid: iid for iid in instance_to_class}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    import cv2

    kernel = np.ones((2 * gap + 1,) * 2, np.uint8)
    for cid, ids in fragments.items():
        if len(ids) < 2:
            continue
        masks = {i: instance_label == i for i in ids}
        areas = {i: int(masks[i].sum()) for i in ids}
        dil = {
            i: cv2.dilate(masks[i].astype(np.uint8), kernel).astype(bool)
            for i in ids
        }
        k3 = np.ones((3, 3), np.uint8)
        for a_i, i in enumerate(ids):
            for j in ids[a_i + 1:]:
                band = dil[i] & dil[j] & ~masks[i] & ~masks[j]
                adjacent = bool(
                    (
                        cv2.dilate(
                            masks[i].astype(np.uint8), k3
                        ).astype(bool)
                        & masks[j]
                    ).any()
                )
                small, big = sorted((areas[i], areas[j]))
                if small < min_frac * big:
                    if adjacent or band.any():
                        union(i, j)
                    continue
                if adjacent or not band.any():
                    continue
                cm = class_map[band]
                n_occ = int(((cm > 0) & (cm != cid)).sum())
                n_bg = int((cm == 0).sum())
                if n_occ > n_bg:
                    union(i, j)

    roots = sorted({find(i) for i in instance_to_class})
    remap = {}
    for new_id, root in enumerate(roots):
        remap[root] = new_id
    lut = {i: remap[find(i)] for i in instance_to_class}
    out_label = np.full_like(instance_label, -1)
    for iid, nid in lut.items():
        out_label[instance_label == iid] = nid
    out_classes = {
        remap[root]: instance_to_class[root] for root in roots
    }
    return out_label, out_classes


def instances_from_class_map(
    class_map: np.ndarray,
    scores: np.ndarray = None,
    min_area: int = 50,
) -> Tuple[np.ndarray, Dict[int, int]]:
    """Class map -> (instance_label (H, W), {instance_id: class_id}).

    Largest connected component per class (the ROS node's
    one-instance-per-class contract); smaller blobs are suppressed.
    """
    import cv2

    H, W = class_map.shape
    instance_label = np.full((H, W), -1, np.int32)
    instance_to_class: Dict[int, int] = {}
    next_id = 0
    for cid in np.unique(class_map):
        if cid <= 0:
            continue
        mask = (class_map == cid).astype(np.uint8)
        n, comp = cv2.connectedComponents(mask)
        best, best_area = None, min_area
        for k in range(1, n):
            area = int((comp == k).sum())
            if area >= best_area:
                best, best_area = k, area
        if best is None:
            continue
        instance_label[comp == best] = next_id
        instance_to_class[next_id] = int(cid)
        next_id += 1
    return instance_label, instance_to_class


def miou(class_map_pred: np.ndarray, class_map_true: np.ndarray,
         n_class: int = 22) -> float:
    """Mean IoU over classes present in either map (incl. background)."""
    ious = []
    for c in range(n_class):
        p = class_map_pred == c
        t = class_map_true == c
        union = (p | t).sum()
        if union == 0:
            continue
        ious.append((p & t).sum() / union)
    return float(np.mean(ious)) if ious else 0.0


def match_instances(
    pred_label: np.ndarray,
    pred_classes: Dict[int, int],
    gt_label: np.ndarray,
    gt_classes: Dict[int, int],
    iou_threshold: float = 0.5,
) -> Tuple[int, int, int]:
    """Greedy IoU matching of predicted to GT instances (same class only).

    Returns (n_matched, n_gt, n_pred) — detection rate = matched / gt.
    """
    used = set()
    n_matched = 0
    for gid, gcls in gt_classes.items():
        gmask = gt_label == gid
        if not gmask.any():
            continue
        best, best_iou = None, iou_threshold
        for pid, pcls in pred_classes.items():
            if pid in used or pcls != gcls:
                continue
            pmask = pred_label == pid
            inter = (gmask & pmask).sum()
            if inter == 0:
                continue
            iou = inter / (gmask | pmask).sum()
            if iou >= best_iou:
                best, best_iou = pid, iou
        if best is not None:
            used.add(best)
            n_matched += 1
    n_gt = sum(1 for g in gt_classes if (gt_label == g).any())
    return n_matched, n_gt, len(pred_classes)


class SegmentationNode:
    """Runtime segmenter: RGB(-D) frame -> ``(instance_label, {id: class})``.

    Plugs into ``ScenePipeline(segmenter=...)``. ``model`` is a port
    ``UNetSegmentation`` with its weights loaded; it runs on ``device`` (the
    card unless the caller passes ``device="cpu"``). With
    ``device_instancing=True`` the forward, the argmax, the boundary
    ``> 0`` and the connected components run on the device, then one copy
    of ``(class_map, comp)`` goes to the host for the relabel. With
    ``device_instancing=False`` the class map and boundary go to the host
    and cv2 recovers the instances (``instances_from_predictions``).
    ``merge_splits`` runs ``merge_occlusion_splits`` after either.
    """

    def __init__(
        self,
        model: UNetSegmentation,
        min_area: int = 50,
        device_instancing: bool = True,
        merge_splits: bool = True,
        device="cuda",
    ):
        self._device = torch.device(device)
        self._model = model.to(self._device).eval()
        self._min_area = min_area
        self._device_instancing = device_instancing
        self._merge_splits = merge_splits

    @torch.inference_mode()
    def _predict(self, rgb: np.ndarray, depth=None):
        """The device part: ``(class_map, comp)`` as one ``(2, H, W)``
        int32 host array with device instancing, else ``(class_map,
        boundary or None)``."""
        dev = self._device
        x = torch.from_numpy(np.asarray(rgb, np.float32)[None]).to(dev)
        kw = {}
        if self._model.use_depth:
            if depth is None:
                depth = np.zeros(rgb.shape[:2], np.float32)
            kw["depth"] = torch.from_numpy(
                np.asarray(depth, np.float32)[None]).to(dev)
        out = self._model(x, **kw)
        if self._model.with_boundary:
            logits, blog = out
            bnd = blog[0] > 0.0
        else:
            logits, bnd = out, None
        class_map = torch.argmax(logits[0], dim=0).to(torch.int32)
        if not self._device_instancing:
            return (class_map.cpu().numpy(),
                    None if bnd is None else bnd.cpu().numpy())
        comp = connected_components(class_map, bnd)
        return torch.stack([class_map, comp]).cpu().numpy()

    def __call__(self, rgb: np.ndarray, depth=None):
        if self._device_instancing:
            cm, comp = self._predict(rgb, depth)
            label, classes = relabel_components(comp, cm,
                                                min_area=self._min_area)
        else:
            cm, bnd = self._predict(rgb, depth)
            label, classes = instances_from_predictions(
                cm, bnd, min_area=self._min_area)
        if self._merge_splits:
            label, classes = merge_occlusion_splits(label, classes, cm)
        return label, classes
