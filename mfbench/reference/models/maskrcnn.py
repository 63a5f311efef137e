"""Mask R-CNN with a ResNet-50 FPN, in plain PyTorch and float32, written
from the published description and not from the port's code: He et al.,
ICCV 2017 (arXiv:1703.06870), with the FPN of Lin et al., CVPR 2017
(arXiv:1612.03144), in Detectron's layout as torchvision's
``maskrcnn_resnet50_fpn`` states its defaults. It shares with the port only
the ``state_dict`` layout, so that both take the same weights.

- ResNet-50 (bottlenecks 3, 4, 6, 3; stride on the 3x3; BatchNorm frozen,
  ``(x - mean) / sqrt(var + 1e-5) * weight + bias``), FPN P2-P6 (1x1
  laterals, nearest x2 top-down, 3x3 outputs, P6 = P5 subsampled by 2).
- RPN: anchors of one size a level (32-512 px at strides 4-64), ratios h /
  w of 0.5, 1, 2, the base box ``(-w/2, -h/2, w/2, h/2)`` rounded; a
  location's anchors in ratio order, locations row by row.
- Boxes decode from deltas by the box coder (weights 1, 1, 1, 1 for the RPN,
  10, 10, 5, 5 for the box head; dw, dh clipped at log(1000 / 16)).
- Proposals: a level's 1000 best by objectness (ties to the lower index),
  decoded, clipped to the image, sides under 1e-3 dropped, greedy NMS at
  0.7; the 1000 best kept of all levels.
- Detections: every (proposal, class >= 1) pair by softmax score, the 1000
  best, decoded, clipped, greedy NMS at 0.5 class by class, the first k.
- Masks: the class's 28x28 channel, sigmoid, resized into the detection's
  integer box in the frame (``F.interpolate``, bilinear,
  ``align_corners=False``) and thresholded at 0.5; the higher score first.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.nms import greedy_nms
from ..ops.roi_align import roi_align

MEAN_RGB = (0.485, 0.456, 0.406)
STD_RGB = (0.229, 0.224, 0.225)
CLIP = math.log(1000.0 / 16)
BLOCKS = (3, 4, 6, 3)
SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)
STRIDES = (4, 8, 16, 32, 64)
DIVISOR = 32
RPN_NMS, DET_NMS = 0.7, 0.5
BOX_POOL, MASK_POOL = 7, 14


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        return ((x - self.running_mean.view(shape))
                / torch.sqrt(self.running_var.view(shape) + 1e-5)
                * self.weight.view(shape) + self.bias.view(shape))


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(4 * width)
        self.downsample = None
        if stride != 1 or cin != 4 * width:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, 4 * width, 1, stride, bias=False),
                FrozenBatchNorm2d(4 * width))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class Body(nn.Module):
    def __init__(self, width, blocks):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        cin = width
        for i, n in enumerate(blocks):
            layer = []
            for b in range(n):
                layer.append(Bottleneck(cin, width << i,
                                        2 if (i > 0 and b == 0) else 1))
                cin = 4 * (width << i)
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.n_stages = len(blocks)

    def forward(self, x):
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        out = []
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            out.append(x)
        return out


class FPN(nn.Module):
    def __init__(self, in_channels, channels):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [nn.Conv2d(c, channels, 1) for c in in_channels])
        self.layer_blocks = nn.ModuleList(
            [nn.Conv2d(channels, channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, cs):
        tops = [None] * len(cs)
        tops[-1] = self.inner_blocks[-1](cs[-1])
        for i in reversed(range(len(cs) - 1)):
            up = tops[i + 1].repeat_interleave(2, 2).repeat_interleave(2, 3)
            tops[i] = self.inner_blocks[i](cs[i]) + up
        ps = [conv(t) for conv, t in zip(self.layer_blocks, tops)]
        return ps + [ps[-1][:, :, ::2, ::2]]


class RPN(nn.Module):
    def __init__(self, channels, anchors):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, 4 * anchors, 1)

    def forward(self, ps):
        """Per level ``(H W A,)`` objectness and ``(H W A, 4)`` deltas in
        the anchors' order."""
        scores, deltas = [], []
        for p in ps:
            t = torch.relu(self.conv(p))
            s = self.cls_logits(t)[0]  # (A, H, W)
            d = self.bbox_pred(t)[0]  # (A * 4, H, W)
            A = s.shape[0]
            scores.append(s.permute(1, 2, 0).flatten())
            deltas.append(d.view(A, 4, *d.shape[1:]).permute(2, 3, 0, 1)
                          .reshape(-1, 4))
        return scores, deltas


class BoxHead(nn.Module):
    def __init__(self, in_features, hidden, n_class):
        super().__init__()
        self.fc6 = nn.Linear(in_features, hidden)
        self.fc7 = nn.Linear(hidden, hidden)
        self.cls_score = nn.Linear(hidden, n_class)
        self.bbox_pred = nn.Linear(hidden, 4 * n_class)

    def forward(self, x):
        x = torch.relu(self.fc7(torch.relu(self.fc6(x.flatten(1)))))
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    def __init__(self, cin, channels, n_class):
        super().__init__()
        self.mask_fcn1 = nn.Conv2d(cin, channels, 3, padding=1)
        self.mask_fcn2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.mask_fcn3 = nn.Conv2d(channels, channels, 3, padding=1)
        self.mask_fcn4 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv5_mask = nn.ConvTranspose2d(channels, channels, 2, 2)
        self.mask_fcn_logits = nn.Conv2d(channels, n_class, 1)

    def forward(self, x):
        for conv in (self.mask_fcn1, self.mask_fcn2, self.mask_fcn3,
                     self.mask_fcn4, self.conv5_mask):
            x = torch.relu(conv(x))
        return self.mask_fcn_logits(x)


def anchors_of(size, stride, H, W, ratios, device):
    ratios = torch.tensor(ratios, dtype=torch.float32, device=device)
    hr = ratios.sqrt()
    wr = 1 / hr
    half_w, half_h = wr * size / 2, hr * size / 2
    base = torch.stack([-half_w, -half_h, half_w, half_h], 1).round()
    ys = torch.arange(H, device=device).float() * stride
    xs = torch.arange(W, device=device).float() * stride
    cx = xs[None, :].expand(H, W)
    cy = ys[:, None].expand(H, W)
    centre = torch.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
    return (centre + base[None]).reshape(-1, 4)


def decode(deltas, ref, weights):
    w = ref[:, 2] - ref[:, 0]
    h = ref[:, 3] - ref[:, 1]
    cx = ref[:, 0] + 0.5 * w
    cy = ref[:, 1] + 0.5 * h
    dx = deltas[:, 0] / weights[0]
    dy = deltas[:, 1] / weights[1]
    dw = (deltas[:, 2] / weights[2]).clamp(max=CLIP)
    dh = (deltas[:, 3] / weights[3]).clamp(max=CLIP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], 1)


def clip(boxes, h, w):
    return torch.stack([boxes[:, 0].clamp(0, w), boxes[:, 1].clamp(0, h),
                        boxes[:, 2].clamp(0, w), boxes[:, 3].clamp(0, h)], 1)


class MaskRCNN(nn.Module):
    def __init__(self, n_class=22, width=64, fpn_channels=256,
                 representation=1024, mask_channels=256, min_size=800,
                 max_size=1333, rpn_pre_nms_top_n=1000,
                 rpn_post_nms_top_n=1000, box_candidates=1000):
        super().__init__()
        self.n_class = n_class
        self.min_size, self.max_size = min_size, max_size
        self.pre_nms, self.post_nms = rpn_pre_nms_top_n, rpn_post_nms_top_n
        self.candidates = box_candidates
        self.body = Body(width, BLOCKS)
        self.fpn = FPN([4 * (width << i) for i in range(len(BLOCKS))],
                       fpn_channels)
        self.rpn = RPN(fpn_channels, len(RATIOS))
        self.box_head = BoxHead(fpn_channels * BOX_POOL * BOX_POOL,
                                representation, n_class)
        self.mask_head = MaskHead(fpn_channels, mask_channels, n_class)

    # ---------------------------------------------------------- the image
    def input_size(self, H, W):
        """The resized ``(h, w)`` (shorter side ``min_size``, longer at most
        ``max_size``, floored) and the padded ``(Hp, Wp)``."""
        s = min(self.min_size / min(H, W), self.max_size / max(H, W))
        h, w = int(H * s + 1e-6), int(W * s + 1e-6)
        d = DIVISOR
        return (h, w), ((h + d - 1) // d * d, (w + d - 1) // d * d)

    def image(self, rgb):
        """``(H, W, 3)`` uint8 tensor -> ``(1, 3, Hp, Wp)`` and ``(h, w)``."""
        (h, w), (hp, wp) = self.input_size(*rgb.shape[:2])
        mean = torch.tensor(MEAN_RGB, device=rgb.device)
        std = torch.tensor(STD_RGB, device=rgb.device)
        x = ((rgb.float() / 255 - mean) / std).permute(2, 0, 1)[None]
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False)
        out = torch.zeros((1, 3, hp, wp), device=rgb.device)
        out[:, :, :h, :w] = x
        return out, (h, w)

    def features(self, image):
        return self.fpn(self.body(image))

    def anchors(self, ps):
        return [anchors_of(size, stride, p.shape[2], p.shape[3], RATIOS,
                           p.device)
                for size, stride, p in zip(SIZES, STRIDES, ps)]

    # ---------------------------------------------------------- selection
    def proposals(self, scores, deltas, anchors, hw):
        """``index`` (anchor indices over all levels) and ``boxes`` of the
        kept proposals, best first."""
        h, w = hw
        kept_boxes, kept_scores, kept_index = [], [], []
        offset = 0
        for s, d, a in zip(scores, deltas, anchors):
            top = torch.argsort(s, descending=True, stable=True)[
                :self.pre_nms]
            boxes = clip(decode(d[top], a[top], (1.0, 1.0, 1.0, 1.0)), h, w)
            big = ((boxes[:, 2] - boxes[:, 0] >= 1e-3)
                   & (boxes[:, 3] - boxes[:, 1] >= 1e-3))
            top, boxes = top[big], boxes[big]
            keep = torch.tensor(greedy_nms(boxes, RPN_NMS),
                                dtype=torch.long, device=boxes.device)
            kept_boxes.append(boxes[keep])
            kept_scores.append(s[top[keep]])
            kept_index.append(top[keep] + offset)
            offset += len(s)
        boxes = torch.cat(kept_boxes)
        best = torch.argsort(torch.cat(kept_scores), descending=True,
                             stable=True)[:self.post_nms]
        return dict(index=torch.cat(kept_index)[best], boxes=boxes[best])

    def detections(self, proposals, valid, cls_logits, box_deltas, k, hw):
        """``index`` (pair indices ``proposal * (n_class - 1) + class -
        1``), ``boxes``, ``classes`` and ``scores`` of the first ``k``
        kept detections, best first; only ``valid`` proposals take part."""
        h, w = hw
        nc = self.n_class
        probs = torch.softmax(cls_logits, 1)[:, 1:]
        rows = torch.nonzero(valid)[:, 0]
        pair = (rows[:, None] * (nc - 1)
                + torch.arange(nc - 1, device=rows.device)[None]).flatten()
        score = probs[rows].flatten()
        best = torch.argsort(score, descending=True, stable=True)[
            :self.candidates]
        pair, score = pair[best], score[best]
        roi, cls = pair // (nc - 1), pair % (nc - 1) + 1
        d = box_deltas.view(len(box_deltas), nc, 4)[roi, cls]
        boxes = clip(decode(d, proposals[roi], (10.0, 10.0, 5.0, 5.0)),
                     h, w)
        kept = []
        for c in torch.unique(cls).tolist():
            members = torch.nonzero(cls == c)[:, 0]
            kept += [int(members[i]) for i in
                     greedy_nms(boxes[members], DET_NMS)]
        first = sorted(kept)[:k]
        first = torch.tensor(first, dtype=torch.long, device=boxes.device)
        return dict(index=pair[first], boxes=boxes[first], classes=cls[first],
                    scores=score[first])

    # -------------------------------------------------------------- heads
    def box_outputs(self, ps, boxes):
        return self.box_head(roi_align(ps[:4], boxes, BOX_POOL))

    def mask_logits(self, ps, boxes, classes):
        logits = self.mask_head(roi_align(ps[:4], boxes, MASK_POOL))
        return logits[torch.arange(len(boxes), device=boxes.device), classes]

    def paste(self, logits, boxes, hw, H, W):
        """The ``(H, W)`` int32 instance image of the detections (boxes in
        input pixels, best first)."""
        h, w = hw
        ratio = (torch.tensor([W, H, W, H], dtype=torch.float32)
                 / torch.tensor([w, h, w, h], dtype=torch.float32)).to(
            boxes.device)
        label = torch.zeros((H, W), dtype=torch.int32, device=boxes.device)
        probs = torch.sigmoid(logits)
        for i, box in enumerate((boxes * ratio).floor().long().tolist()):
            x0, y0, x1, y1 = box
            bw, bh = max(x1 - x0 + 1, 1), max(y1 - y0 + 1, 1)
            m = F.interpolate(probs[i][None, None], size=(bh, bw),
                              mode="bilinear", align_corners=False)[0, 0]
            m = m >= 0.5
            ya, yb = max(y0, 0), min(y0 + bh, H)
            xa, xb = max(x0, 0), min(x0 + bw, W)
            if ya >= yb or xa >= xb:
                continue
            region = label[ya:yb, xa:xb]
            hit = m[ya - y0:yb - y0, xa - x0:xb - x0] & (region == 0)
            region[hit] = i + 1
        return label
