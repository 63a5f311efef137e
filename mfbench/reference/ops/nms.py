"""Greedy non-maximum suppression, the textbook loop, in plain PyTorch on
the host: walk the boxes from the highest score down; keep a box that no
kept box has suppressed, and suppress every later box whose IoU with it
exceeds the threshold. IoU is the intersection's area over the union's,
``inter / (area_a + area_b - inter)``, in float32.
"""

from __future__ import annotations

import torch


def iou(box, boxes):
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iw = torch.clamp(torch.minimum(boxes[:, 2], box[2])
                     - torch.maximum(boxes[:, 0], box[0]), min=0)
    ih = torch.clamp(torch.minimum(boxes[:, 3], box[3])
                     - torch.maximum(boxes[:, 1], box[1]), min=0)
    inter = iw * ih
    return inter / (area + areas - inter)


def greedy_nms(boxes, threshold):
    """Positions (in order) of the boxes kept among ``boxes (n, 4)``, which
    are sorted by score, highest first."""
    boxes = boxes.detach().cpu().float()
    threshold = torch.tensor(threshold, dtype=torch.float32)
    suppressed = torch.zeros(len(boxes), dtype=torch.bool)
    kept = []
    for i in range(len(boxes)):
        if suppressed[i]:
            continue
        kept.append(i)
        suppressed[i + 1:] |= iou(boxes[i], boxes[i + 1:]) > threshold
    return kept
