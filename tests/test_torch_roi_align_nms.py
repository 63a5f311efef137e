"""Mask R-CNN's two kernels on the card (``-m cuda``; each test skips
without one) against their plain versions, at the shapes of the benchmark's
``maskrcnn_r50_fpn.serve.seg1`` cell (an 800 x 1088 input, 256 channels):

- ``csrc/roi_align.cu`` against ``roi_align_plain`` on the same card: the
  box call (1000 RoIs, 7 x 7) and the mask call (8 RoIs, 14 x 14), RoIs of
  every level, with RoIs on the levels' size boundaries (a flipped level
  would read another map), under 1 px and off the map; within float32
  rounding (the two compute the same operations, so the bits agree), and
  the same bits on two runs;
- ``csrc/nms.cu`` against ``nms_plain`` (the greedy walk on the host): the
  proposals' call (five levels of 1000, 1000, 1000, 1000 and 663 boxes at
  0.7) and the detections' (1000 boxes, 21 labels, some invalid, at 0.5):
  identical keep flags, and on two runs; boxes of equal scores and IoUs
  exactly at the threshold.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_roi_align_nms.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from morefusion_tpu_torch.ops import nms as N
from morefusion_tpu_torch.ops import roi_align as RA

LEVEL_HW = [(200, 272), (100, 136), (50, 68), (25, 34)]
IMAGE_HW = (800, 1066)
C = 256


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def random_boxes(n, seed, hw=IMAGE_HW):
    """Boxes of sizes 2-700 px (every level), some crossing the border."""
    r = np.random.RandomState(seed)
    h, w = hw
    side = np.exp(r.uniform(np.log(2), np.log(700), (n, 2)))
    cx, cy = r.uniform(-20, w + 20, n), r.uniform(-20, h + 20, n)
    boxes = np.stack([cx - side[:, 0] / 2, cy - side[:, 1] / 2,
                      cx + side[:, 0] / 2, cy + side[:, 1] / 2], 1)
    return torch.from_numpy(boxes.astype(np.float32))


def edge_rois():
    """Squares whose sqrt(area) / 224 + 1e-6 lies at and around the level
    boundaries (112, 224, 448 px), RoIs under 1 px, and RoIs off the map."""
    out = []
    for side in (112.0, 224.0, 448.0):
        s = np.float32(side)
        for v in (np.nextafter(s, np.float32(0)), s,
                  np.nextafter(s, np.float32(1e9)), s - 0.01, s + 0.01):
            out.append([10.0, 20.0, 10.0 + float(v), 20.0 + float(v)])
    out += [[5.0, 5.0, 5.3, 5.2], [300.0, 400.0, 300.0, 400.0],
            [1060.0, 790.0, 1100.0, 900.0], [-60.0, -40.0, -5.0, -2.0],
            [-10.0, 300.0, 2000.0, 310.0]]
    return torch.tensor(out, dtype=torch.float32)


def pyramid(device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn((1, C, h, w), generator=g, device=device)
            for h, w in LEVEL_HW]


@pytest.mark.cuda
@pytest.mark.parametrize("P,n", [(7, 1000), (14, 8)])
def test_roi_align_matches_plain(P, n):
    dev = _card()
    feats = pyramid(dev)
    rois = torch.cat([random_boxes(n, 1 + P), edge_rois()]).to(dev)
    before = RA.roi_align.launches
    got = RA.roi_align(feats, rois, P)
    again = RA.roi_align(feats, rois, P)
    torch.cuda.synchronize()
    assert RA.roi_align.launches == before + 2
    want = RA.roi_align_plain(feats, rois, P)
    assert torch.equal(got, again)
    scale = max(float(f.abs().max()) for f in feats)
    assert float((got - want).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_roi_align_levels_on_the_card():
    """The kernel's level is torch's on the card: a RoI on each boundary
    reads the level ``roi_levels`` gives it (each level a constant map)."""
    dev = _card()
    feats = [torch.full((1, 1, h, w), float(l), device=dev)
             for l, (h, w) in enumerate(LEVEL_HW)]
    near = []
    for j in (-1, 0, 1):  # the sides where the level changes, ulp by ulp
        s = np.float32(224 * (2.0 ** j - 1e-6))
        for _ in range(64):
            s = np.nextafter(s, np.float32(0))
        for _ in range(129):
            near.append(float(s))
            s = np.nextafter(s, np.float32(1e9))
    sides = torch.cat([torch.linspace(20.0, 900.0, 200001),
                       torch.tensor(near, dtype=torch.float32)])
    rois = torch.stack([torch.zeros_like(sides), torch.zeros_like(sides),
                        sides, sides], 1)
    rois = torch.cat([rois, edge_rois()[:15]]).to(dev)
    got = RA.roi_align(feats, rois, 1)[:, 0, 0, 0]
    assert torch.equal(got.round().long(), RA.roi_levels(rois))


def proposal_groups(seed):
    sizes = [1000, 1000, 1000, 1000, 663]
    boxes = torch.cat([random_boxes(n, seed + i) for i, n in
                       enumerate(sizes)])
    boxes = torch.stack([boxes[:, 0].clamp(0, 1066), boxes[:, 1].clamp(0, 800),
                         boxes[:, 2].clamp(0, 1066), boxes[:, 3].clamp(0, 800)],
                        1)
    valid = ((boxes[:, 2] - boxes[:, 0] >= 1e-3)
             & (boxes[:, 3] - boxes[:, 1] >= 1e-3))
    starts = np.cumsum([0] + sizes[:-1])
    return boxes, valid, list(zip(starts.tolist(), sizes))


@pytest.mark.cuda
def test_nms_proposals_match_plain():
    dev = _card()
    boxes, valid, groups = proposal_groups(5)
    want = N.nms_plain(boxes, 0.7, groups, valid=valid)
    got = [N.nms(boxes.to(dev), 0.7, groups, valid=valid.to(dev)).cpu()
           for _ in range(2)]
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
    assert 0 < int(want.sum()) < len(want)


@pytest.mark.cuda
def test_nms_detections_match_plain():
    dev = _card()
    r = np.random.RandomState(9)
    boxes = random_boxes(1000, 9)
    labels = torch.from_numpy(r.randint(1, 22, 1000).astype(np.int32))
    valid = torch.from_numpy(r.rand(1000) > 0.05)
    want = N.nms_plain(boxes, 0.5, labels=labels, valid=valid)
    got = [N.nms(boxes.to(dev), 0.5, labels=labels.to(dev),
                 valid=valid.to(dev)).cpu() for _ in range(2)]
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


@pytest.mark.cuda
def test_nms_ties_and_exact_threshold_on_the_card():
    dev = _card()
    # IoU of the first two exactly 0.5 (not suppressed at 0.5), the third
    # a copy of the first (suppressed), the fourth zero-area (NaN IoU with
    # itself, kept), the fifth invalid
    boxes = torch.tensor([[0, 0, 10, 10], [0, 0, 10, 5], [0, 0, 10, 10],
                          [3, 3, 3, 3], [0, 0, 10, 10]], dtype=torch.float32)
    valid = torch.tensor([True, True, True, True, False])
    want = torch.tensor([True, True, False, True, False])
    assert torch.equal(N.nms_plain(boxes, 0.5, valid=valid), want)
    assert torch.equal(N.nms(boxes.to(dev), 0.5, valid=valid.to(dev)).cpu(),
                       want)
