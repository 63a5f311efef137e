"""Mask R-CNN with a ResNet-50 FPN: MoreFusion's published instance
segmenter, and a segmentation node for the scene pipeline.

MoreFusion segments each frame with ChainerCV's ``MaskRCNNFPNResNet50``
(He et al., ICCV 2017, arXiv:1703.06870, with the FPN of Lin et al., CVPR
2017, arXiv:1612.03144), served on a card of its own ahead of the pose
network. The JAX package has none (its segmenter is the UNet of
``models/segmentation.py``). The layout here is Detectron's, as
torchvision's ``maskrcnn_resnet50_fpn`` writes down its defaults (named as a
source, not imported):

- ResNet-50, bottleneck blocks (3, 4, 6, 3) with the stride on the 3x3,
  BatchNorm frozen on its statistics; C2-C5;
- FPN: 1x1 laterals and 3x3 outputs of 256, nearest x2 top-down, P6 a
  max-pool of P5 (kernel 1, stride 2);
- RPN: a 3x3 conv and 1x1 objectness and delta convs shared over P2-P6;
  anchors of 32-512 px (one size a level) at ratios 0.5, 1, 2;
- box head: RoIAlign 7x7 over P2-P5, two FCs of 1024, class scores and
  class-specific deltas; mask head: RoIAlign 14x14, four 3x3 convs of 256,
  a 2x2 stride-2 deconvolution, a 1x1 conv to the classes (28x28).

A frame (:class:`MaskRCNNSegmentationNode`): the ImageNet normalization,
the bilinear resize (``ops/resize.py``) to the shorter side ``min_size``
(the longer at most ``max_size``), zero padding to a multiple of 32; the
top ``rpn_pre_nms_top_n`` anchors of each level by objectness, decoded
(weights 1, 1, 1, 1), clipped, those under 1e-3 px a side dropped, NMS at
0.7 within each level (``ops/nms.py``), the top
``rpn_post_nms_top_n`` overall; the box head on them (``ops/roi_align.py``),
the top ``box_candidates`` (RoI, class) pairs by softmax score, decoded
(weights 10, 10, 5, 5) and clipped, NMS at 0.5 within each class, the
first ``max_instances`` kept; the mask head on those, each mask's
class channel pasted into the frame at its box (the bilinear rule of
``F.interpolate``, ``align_corners=False``, from 28x28 to the box's integer
size, threshold 0.5, the higher score winning an overlap), one
``(H, W)`` int32 instance image and the classes copied to the host. Every
step after the upload runs on the device with no read-back before that copy:
shapes are fixed (invalid entries are masked, not dropped), sorts and top-k
break ties by the lower index, and a box ranks by its objectness logit.

fp32, with TF32 off as the port's contract sets it: the layers are
``models/layers.py``'s at fp32 (the stock PyTorch layers).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops.nms import nms
from ..ops.roi_align import roi_align
from ..ops.resize import resize_bilinear
from ..utils import profiling
from .layers import Conv2d, FrozenBatchNorm2d, Linear
from .resnet import normalize_rgb

#: dw and dh are clipped here before the exp (Detectron's)
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
RPN_BOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
DET_BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
MIN_PROPOSAL_SIDE = 1e-3
MASK_THRESHOLD = 0.5
STRIDES = (4, 8, 16, 32, 64)  # P2-P6
BLOCKS = (3, 4, 6, 3)  # ResNet-50's bottlenecks a stage
ANCHOR_SIZES = (32, 64, 128, 256, 512)  # one a level, P2-P6
ASPECT_RATIOS = (0.5, 1.0, 2.0)  # h / w
SIZE_DIVISIBLE = 32
RPN_NMS_THRESH = 0.7
BOX_NMS_THRESH = 0.5
BOX_POOL, MASK_POOL = 7, 14


# ---------------------------------------------------------------- backbone


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels, width, stride=1):
        super().__init__()
        out = width * self.expansion
        self.conv1 = Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = Conv2d(width, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = None
        if stride != 1 or in_channels != out:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, out, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(out))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        skip = x if self.downsample is None else self.downsample(x)
        return F.relu(h + skip)


class ResNet50(nn.Module):
    """ResNet-50 with frozen BatchNorm: ``(1, 3, H, W)`` -> C2-C5 at
    strides 4-32 with ``4 * width * (1, 2, 4, 8)`` channels."""

    def __init__(self, width=64, blocks=BLOCKS):
        super().__init__()
        self.conv1 = Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        cin = width
        for i, n in enumerate(blocks):
            w = width * 2 ** i
            layer = []
            for b in range(n):
                layer.append(Bottleneck(cin, w, 2 if b == 0 and i > 0 else 1))
                cin = w * Bottleneck.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))
        self.out_channels = [width * 2 ** i * Bottleneck.expansion
                             for i in range(len(blocks))]

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        out = []
        for i in range(len(self.out_channels)):
            h = getattr(self, f"layer{i + 1}")(h)
            out.append(h)
        return out


class FPN(nn.Module):
    """C2-C5 -> P2-P6 of ``channels`` each."""

    def __init__(self, in_channels: Sequence[int], channels=256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            Conv2d(c, channels, 1) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            Conv2d(channels, channels, 3, padding=1) for _ in in_channels)

    def forward(self, cs):
        last = self.inner_blocks[-1](cs[-1])
        out = [self.layer_blocks[-1](last)]
        for i in range(len(cs) - 2, -1, -1):
            lateral = self.inner_blocks[i](cs[i])
            last = lateral + F.interpolate(last, size=lateral.shape[-2:],
                                           mode="nearest")
            out.insert(0, self.layer_blocks[i](last))
        out.append(F.max_pool2d(out[-1], 1, stride=2))  # P6
        return out


class RPNHead(nn.Module):
    def __init__(self, channels, n_anchors):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = Conv2d(channels, n_anchors, 1)
        self.bbox_pred = Conv2d(channels, 4 * n_anchors, 1)

    def forward(self, features):
        """Per level ``(H W A,)`` objectness and ``(H W A, 4)`` deltas, in
        the anchors' order (row, column, ratio)."""
        objectness, deltas = [], []
        for f in features:
            h = F.relu(self.conv(f))
            o = self.cls_logits(h)[0]  # (A, H, W)
            d = self.bbox_pred(h)[0]  # (4A, H, W)
            A, H, W = o.shape
            objectness.append(o.permute(1, 2, 0).reshape(-1))
            deltas.append(d.reshape(A, 4, H, W).permute(2, 3, 0, 1)
                          .reshape(-1, 4))
        return objectness, deltas


class BoxHead(nn.Module):
    def __init__(self, in_features, representation, n_class):
        super().__init__()
        self.fc6 = Linear(in_features, representation)
        self.fc7 = Linear(representation, representation)
        self.cls_score = Linear(representation, n_class)
        self.bbox_pred = Linear(representation, 4 * n_class)

    def forward(self, x):
        h = F.relu(self.fc6(x.flatten(1)))
        h = F.relu(self.fc7(h))
        return self.cls_score(h), self.bbox_pred(h)


class MaskHead(nn.Module):
    def __init__(self, in_channels, channels, n_class):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}", Conv2d(
                in_channels if i == 0 else channels, channels, 3, padding=1))
        self.conv5_mask = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.mask_fcn_logits = Conv2d(channels, n_class, 1)

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


# ------------------------------------------------------------------ boxes


def level_anchors(size, ratios, stride, H, W, device):
    """``(H W A, 4)`` anchors of one level: the rounded base boxes of
    ``size`` at ``ratios`` (h / w), shifted to every location."""
    r = torch.tensor(ratios, dtype=torch.float32, device=device)
    h_ratio = torch.sqrt(r)
    ws = (1.0 / h_ratio) * size
    hs = h_ratio * size
    base = (torch.stack([-ws, -hs, ws, hs], 1) / 2).round()
    sx = torch.arange(W, dtype=torch.float32, device=device) * stride
    sy = torch.arange(H, dtype=torch.float32, device=device) * stride
    yy, xx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([xx, yy, xx, yy], -1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_boxes(deltas, boxes, weights):
    """Boxes from ``(n, 4)`` deltas on ``(n, 4)`` reference boxes (the
    box coder's rule, dw and dh clipped at log(1000 / 16))."""
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx = deltas[:, 0] / wx
    dy = deltas[:, 1] / wy
    dw = torch.clamp(deltas[:, 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[:, 3] / wh, max=BBOX_XFORM_CLIP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h],
                       1)


def clip_boxes(boxes, hw):
    h, w = hw
    return torch.stack([boxes[:, 0].clamp(0, w), boxes[:, 1].clamp(0, h),
                        boxes[:, 2].clamp(0, w), boxes[:, 3].clamp(0, h)], 1)


def _sort_desc(x):
    return torch.sort(x, descending=True, stable=True).indices


# ------------------------------------------------------------------ model


class MaskRCNN(nn.Module):
    """Mask R-CNN R50-FPN at the published sizes by default; narrower
    ``width`` (ResNet), ``fpn_channels``, ``representation`` and
    ``mask_channels``, a smaller input and fewer candidates for tests.
    ``n_class`` counts the background. The layout's other sizes are the
    module's constants."""

    box_pool, mask_pool = BOX_POOL, MASK_POOL

    def __init__(self, n_class=22, width=64, fpn_channels=256,
                 representation=1024, mask_channels=256, min_size=800,
                 max_size=1333, rpn_pre_nms_top_n=1000,
                 rpn_post_nms_top_n=1000, box_candidates=1000):
        super().__init__()
        self.n_class = n_class
        self.min_size, self.max_size = min_size, max_size
        self.rpn_pre_nms_top_n = rpn_pre_nms_top_n
        self.rpn_post_nms_top_n = rpn_post_nms_top_n
        self.box_candidates = box_candidates
        self.body = ResNet50(width)
        self.fpn = FPN(self.body.out_channels, fpn_channels)
        self.rpn = RPNHead(fpn_channels, len(ASPECT_RATIOS))
        self.box_head = BoxHead(fpn_channels * BOX_POOL ** 2, representation,
                                n_class)
        self.mask_head = MaskHead(fpn_channels, mask_channels, n_class)
        self._anchors = {}

    # -- shapes
    def resized_size(self, H, W) -> Tuple[int, int]:
        """The frame's size after the resize: shorter side ``min_size``,
        longer at most ``max_size``, floored."""
        scale = min(self.min_size / min(H, W), self.max_size / max(H, W))
        return (int(math.floor(H * scale + 1e-6)),
                int(math.floor(W * scale + 1e-6)))

    def padded_size(self, h, w) -> Tuple[int, int]:
        d = SIZE_DIVISIBLE
        return -(-h // d) * d, -(-w // d) * d

    def anchors(self, features) -> List[torch.Tensor]:
        key = tuple(tuple(f.shape[-2:]) for f in features) + (
            features[0].device,)
        if key not in self._anchors:
            self._anchors[key] = [
                level_anchors(size, ASPECT_RATIOS, stride, *f.shape[-2:],
                              f.device)
                for size, stride, f in zip(ANCHOR_SIZES, STRIDES, features)]
        return self._anchors[key]

    # -- stages
    def preprocess(self, rgb):
        """``(H, W, 3)`` uint8 on the device -> the normalized, resized and
        zero-padded ``(1, 3, Hp, Wp)`` image and the resized ``(h, w)``."""
        H, W = rgb.shape[:2]
        h, w = self.resized_size(H, W)
        x = normalize_rgb(rgb[None]).permute(0, 3, 1, 2).contiguous()
        x = resize_bilinear(x, h, w)
        hp, wp = self.padded_size(h, w)
        return F.pad(x, (0, wp - w, 0, hp - h)), (h, w)

    def features(self, image):
        return self.fpn(self.body(image))

    def select_proposals(self, objectness, deltas, anchors, hw) -> dict:
        """The proposals: per level the top ``rpn_pre_nms_top_n`` anchors
        by objectness, decoded, clipped, NMS within the level; then the top
        ``rpn_post_nms_top_n`` kept overall. ``index`` is each proposal's
        anchor index over all levels; ``valid`` whether it was kept."""
        boxes, scores, index, groups = [], [], [], []
        offset = start = 0
        for obj, d, a in zip(objectness, deltas, anchors):
            k = min(self.rpn_pre_nms_top_n, obj.shape[0])
            top = _sort_desc(obj)[:k]
            boxes.append(clip_boxes(decode_boxes(d[top], a[top],
                                                 RPN_BOX_WEIGHTS), hw))
            scores.append(obj[top])
            index.append(top + offset)
            groups.append((start, k))
            start += k
            offset += obj.shape[0]
        boxes, scores, index = (torch.cat(boxes), torch.cat(scores),
                                torch.cat(index))
        valid = ((boxes[:, 2] - boxes[:, 0] >= MIN_PROPOSAL_SIDE)
                 & (boxes[:, 3] - boxes[:, 1] >= MIN_PROPOSAL_SIDE))
        keep = nms(boxes, RPN_NMS_THRESH, groups, valid=valid)
        ranked = torch.where(keep, scores, torch.full_like(scores,
                                                           -math.inf))
        top = _sort_desc(ranked)[:self.rpn_post_nms_top_n]
        return dict(boxes=boxes[top], valid=keep[top], index=index[top],
                    groups=groups)

    def select_detections(self, proposals, valid, cls_logits, box_deltas,
                          k, hw) -> dict:
        """The detections: the top ``box_candidates`` (proposal, class >= 1)
        pairs by softmax score, decoded, clipped, NMS within each class, the
        first ``k`` kept in score order. ``index`` is each detection's pair
        index ``proposal * (n_class - 1) + class - 1``; ``valid`` whether it
        was kept (fewer than ``k`` kept leaves the rest invalid)."""
        R, nc = cls_logits.shape
        scores = torch.softmax(cls_logits, -1)[:, 1:]
        scores = torch.where(valid[:, None], scores,
                             torch.full_like(scores, -math.inf)).reshape(-1)
        order = _sort_desc(scores)[:self.box_candidates]
        roi = order // (nc - 1)
        cls = order % (nc - 1) + 1
        d = box_deltas.reshape(R, nc, 4)[roi, cls]
        boxes = clip_boxes(decode_boxes(d, proposals[roi], DET_BOX_WEIGHTS),
                           hw)
        cand = scores[order]
        keep = nms(boxes, BOX_NMS_THRESH, labels=cls.to(torch.int32),
                   valid=cand > -math.inf)
        first = torch.sort((~keep).to(torch.int32), stable=True).indices[:k]
        return dict(boxes=boxes[first], classes=cls[first],
                    valid=keep[first], scores=cand[first],
                    index=order[first], candidates=len(order))

    def detect(self, image, hw, k, stages=False) -> dict:
        """Everything after the preprocessing, on the device: the kept
        detections' boxes (input pixels), classes, validity and 28x28 mask
        probabilities (each its class's channel); with ``stages`` also each
        stage's outputs."""
        with profiling.annotate("maskrcnn.backbone"):
            feats = self.features(image)
        with profiling.annotate("maskrcnn.rpn"):
            objectness, deltas = self.rpn(feats)
            props = self.select_proposals(objectness, deltas,
                                          self.anchors(feats), hw)
        profiling.count("maskrcnn.proposals", len(props["boxes"]))
        with profiling.annotate("maskrcnn.box"):
            pooled = roi_align(feats[:4], props["boxes"], BOX_POOL)
            cls_logits, box_deltas = self.box_head(pooled)
            dets = self.select_detections(props["boxes"], props["valid"],
                                          cls_logits, box_deltas, k, hw)
        profiling.count("maskrcnn.detections", len(dets["boxes"]))
        with profiling.annotate("maskrcnn.mask"):
            pooled = roi_align(feats[:4], dets["boxes"], MASK_POOL)
            logits = self.mask_head(pooled)
            logits = logits[torch.arange(len(logits), device=logits.device),
                            dets["classes"]]
            dets["masks"] = torch.sigmoid(logits)
        out = dict(detections=dets, proposals=props)
        if stages:
            out.update(features=feats, objectness=objectness, deltas=deltas,
                       cls_logits=cls_logits, box_deltas=box_deltas,
                       mask_logits=logits)
        return out


# ------------------------------------------------------------------ paste


def _paste_weights(start, size, M, n):
    """``(k, n, M)``: the weights with which pixel ``p`` of an axis of
    ``n`` reads the ``M`` mask cells, for a box of integer ``start`` and
    ``size`` (F.interpolate's bilinear rule, ``align_corners=False``, from
    ``M`` to ``size``); zero outside the box."""
    o = torch.arange(n, device=start.device)[None] - start[:, None]
    inside = (o >= 0) & (o < size[:, None])
    scale = (M / size.to(torch.float32))[:, None]
    src = torch.clamp(scale * (o.to(torch.float32) + 0.5) - 0.5, min=0)
    i0 = src.to(torch.int64).clamp(max=M - 1)
    i1 = (i0 + 1).clamp(max=M - 1)
    l1 = (src - i0.to(torch.float32)) * inside
    l0 = (1.0 - (src - i0.to(torch.float32))) * inside
    w = torch.zeros((*o.shape, M), dtype=torch.float32, device=start.device)
    w.scatter_add_(2, i0[..., None], l0[..., None])
    w.scatter_add_(2, i1[..., None], l1[..., None])
    return w


def paste_masks(masks, boxes, valid, H, W):
    """``(H, W)`` int32 instance image: detection ``i`` (``1 + i``) where
    its ``(M, M)`` mask, resampled into its integer box (``boxes`` in frame
    pixels), reads at least 0.5, the earlier (higher-scored) detection
    winning an overlap; 0 elsewhere."""
    k, M = masks.shape[0], masks.shape[-1]
    b = torch.floor(boxes).to(torch.int64)
    size_x = (b[:, 2] - b[:, 0] + 1).clamp(min=1)
    size_y = (b[:, 3] - b[:, 1] + 1).clamp(min=1)
    wy = _paste_weights(b[:, 1], size_y, M, H)  # (k, H, M)
    wx = _paste_weights(b[:, 0], size_x, M, W)  # (k, W, M)
    prob = torch.bmm(torch.bmm(wy, masks), wx.transpose(1, 2))  # (k, H, W)
    hit = (prob >= MASK_THRESHOLD) & valid[:, None, None]
    rank = torch.arange(k, 0, -1, device=masks.device)
    best = (hit * rank[:, None, None]).amax(0)
    return torch.where(best > 0, k + 1 - best, torch.zeros_like(best)).to(
        torch.int32)


# ------------------------------------------------------------------- node


class MaskRCNNSegmentationNode:
    """Runtime segmenter: RGB frame -> ``(instance_label, {id: class})``.

    Plugs into ``ScenePipeline(segmenter=...)`` as ``SegmentationNode``
    does (the depth is not read). ``model`` is a :class:`MaskRCNN` with its
    weights loaded; it runs on ``device``. A frame keeps at most
    ``max_instances`` detections (per call ``max_instances=``), in the
    place of a score threshold. The frame may not be larger than the
    model's input size (the resize only upsamples on the card).
    ``last`` holds the latest frame's proposals and detections on the
    device.
    """

    def __init__(self, model: MaskRCNN, max_instances: int = 8,
                 device="cuda"):
        self._device = torch.device(device)
        self.model = model.to(self._device).eval()
        self.max_instances = max_instances
        self.last = None

    @torch.inference_mode()
    def run(self, rgb: np.ndarray, max_instances=None, stages=False) -> dict:
        """One frame: ``label`` and ``classes`` on the host (the detections'
        classes, 0 where invalid); with ``stages`` every stage's outputs
        on the device besides."""
        k = self.max_instances if max_instances is None else max_instances
        H, W = rgb.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(rgb, np.uint8)).to(
            self._device)
        image, hw = self.model.preprocess(x)
        out = self.model.detect(image, hw, k, stages=stages)
        dets = out["detections"]
        self.last = dict(proposals=out["proposals"]["boxes"],
                         proposal_groups=out["proposals"]["groups"],
                         detections=dets["boxes"],
                         candidates=dets["candidates"])
        with profiling.annotate("maskrcnn.paste"):
            ratio = (torch.tensor([W, H, W, H], dtype=torch.float32)
                     / torch.tensor([hw[1], hw[0]] * 2, dtype=torch.float32)
                     ).to(self._device)
            label = paste_masks(dets["masks"], dets["boxes"] * ratio,
                                dets["valid"], H, W)
            classes = torch.where(dets["valid"], dets["classes"],
                                  torch.zeros_like(dets["classes"]))
            packed = torch.cat([label.reshape(-1),
                                classes.to(torch.int32)]).cpu().numpy()
        out["label"] = packed[:H * W].reshape(H, W)
        out["classes"] = packed[H * W:]
        out["image_hw"] = hw
        return out

    def __call__(self, rgb: np.ndarray, depth=None, max_instances=None):
        out = self.run(rgb, max_instances)
        classes: Dict[int, int] = {i + 1: int(c)
                                   for i, c in enumerate(out["classes"])
                                   if c > 0}
        return out["label"], classes
