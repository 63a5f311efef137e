"""The port's Mask R-CNN (``models/maskrcnn.py``, ``ops/roi_align.py``,
``ops/nms.py``) against the benchmark's plain reference
(``mfbench/reference/models/maskrcnn.py``, written from the published
description), on the CPU at narrow widths on a 96 x 128 frame of the
benchmark's scenes with a few dozen proposals, on weights drawn from a seed:

- every stage the benchmark's check compares: P2-P6, the RPN's outputs,
  the proposals (the reference's selection on the port's RPN outputs:
  identical anchor indices), the box head on the port's proposals, the
  detections (the reference's selection on the port's head outputs:
  identical pair indices), the mask logits on the port's detections and
  the pasted instance image;
- the anchors and the box decoding, bit for bit;
- NMS against the textbook greedy loop on boxes of a small integer grid
  (equal scores, IoUs exactly at the threshold), with groups and labels;
- RoIAlign at RoIs under 1 px, on the level boundaries and off the map;
- the segmenter in ``ScenePipeline(segmenter=...)`` on one frame.
"""

import numpy as np
import pytest
import torch

from mfbench import generators
from mfbench.drivers.segment_frame import frozen_bn
from mfbench.reference.models import maskrcnn as RM
from mfbench.reference.ops import nms as RN
from mfbench.reference.ops import roi_align as RR
from morefusion_tpu_torch.models import maskrcnn as TMR
from morefusion_tpu_torch.ops import nms as N
from morefusion_tpu_torch.ops import roi_align as RA

torch.set_num_threads(2)

SEED = 2**31 + 77
KW = dict(width=8, fpn_channels=16, representation=32, mask_channels=16,
          min_size=160, max_size=266, rpn_pre_nms_top_n=60,
          rpn_post_nms_top_n=40, box_candidates=80)
K = 6  # detections kept


def seeded(cls):
    model = cls(**KW)
    return frozen_bn(generators.load_weights(model, SEED), SEED).eval()


@pytest.fixture(scope="module")
def frame():
    bank = generators.cad_bank(SEED, (), "cpu")
    host = {k: bank[k].numpy() for k in ("half_extent", "diagonal")}
    return generators.scene_frame(SEED, 0, host, 96, 128, K, 16, 0.02)


@pytest.fixture(scope="module")
def stages(frame):
    """The port's stages on the frame and the reference's on the port's
    inputs, stage by stage."""
    node = TMR.MaskRCNNSegmentationNode(seeded(TMR.MaskRCNN),
                                        device="cpu")
    got = node.run(frame["rgb"], max_instances=K, stages=True)
    ref = seeded(RM.MaskRCNN)
    H, W = frame["rgb"].shape[:2]
    with torch.no_grad():
        image, hw = ref.image(torch.from_numpy(frame["rgb"]))
        feats = ref.features(image)
        objectness, deltas = ref.rpn(feats)
        props = ref.proposals(got["objectness"], got["deltas"],
                              ref.anchors(feats), hw)
        p = got["proposals"]
        cls_logits, box_deltas = ref.box_outputs(feats, p["boxes"])
        dets = ref.detections(p["boxes"], p["valid"], got["cls_logits"],
                              got["box_deltas"], K, hw)
        d = got["detections"]
        logits = ref.mask_logits(feats, d["boxes"][d["valid"]],
                                 d["classes"][d["valid"]])
        label = ref.paste(logits, d["boxes"][d["valid"]], hw, H, W)
    want = dict(features=feats, objectness=objectness, deltas=deltas,
                proposals=props, cls_logits=cls_logits,
                box_deltas=box_deltas, detections=dets, mask_logits=logits,
                label=label, image_hw=hw)
    return got, want


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_input_size_and_features(stages):
    got, want = stages
    assert got["image_hw"] == want["image_hw"] == (160, 213)
    assert [tuple(f.shape[-2:]) for f in got["features"]] == [
        (40, 56), (20, 28), (10, 14), (5, 7), (3, 4)]
    for a, b in zip(got["features"], want["features"]):
        assert rel(a, b) <= 1e-5


def test_rpn_outputs(stages):
    got, want = stages
    for a, b in zip(got["objectness"] + got["deltas"],
                    want["objectness"] + want["deltas"]):
        assert a.shape == b.shape and rel(a, b) <= 1e-5


def test_proposals_select_as_the_reference(stages):
    got, want = stages
    p = got["proposals"]
    v = p["valid"]
    assert int(v.sum()) == KW["rpn_post_nms_top_n"]
    assert torch.equal(p["index"][v], want["proposals"]["index"])
    assert torch.equal(p["boxes"][v], want["proposals"]["boxes"])
    # per level, the top 60 anchors, then NMS within the level
    assert [n for _, n in p["groups"]] == [60, 60, 60, 60, 36]


def test_box_head_on_the_proposals(stages):
    got, want = stages
    assert rel(got["cls_logits"], want["cls_logits"]) <= 1e-5
    assert rel(got["box_deltas"], want["box_deltas"]) <= 1e-5


def test_detections_select_as_the_reference(stages):
    got, want = stages
    d = got["detections"]
    assert bool(d["valid"].all()) and len(d["index"]) == K
    assert torch.equal(d["index"], want["detections"]["index"])
    assert torch.equal(d["boxes"], want["detections"]["boxes"])
    assert torch.equal(d["classes"], want["detections"]["classes"])


def test_masks_and_instance_image(stages):
    got, want = stages
    assert rel(got["mask_logits"], want["mask_logits"]) <= 1e-5
    label = torch.from_numpy(got["label"])
    assert label.dtype == torch.int32 and label.shape == (96, 128)
    assert 0 < int((label > 0).sum())
    assert float((label != want["label"]).double().mean()) <= 1e-3
    assert set(np.unique(got["label"])) <= set(range(K + 1))


def test_node_contract(frame):
    node = TMR.MaskRCNNSegmentationNode(seeded(TMR.MaskRCNN),
                                        max_instances=3, device="cpu")
    label, classes = node(frame["rgb"].astype(np.float32), None)
    assert label.shape == frame["rgb"].shape[:2] and label.dtype == np.int32
    assert sorted(classes) == [1, 2, 3]
    assert all(1 <= c <= 21 for c in classes.values())
    assert set(np.unique(label)) <= {0, 1, 2, 3}


@pytest.mark.parametrize("level,size", [(0, 40), (1, 100), (2, 300),
                                        (3, 500), (4, 900)])
def test_anchors_and_decoding_bit_for_bit(level, size):
    stride = TMR.STRIDES[level]
    H, W = 7, 9
    got = TMR.level_anchors(size, (0.5, 1.0, 2.0), stride, H, W, "cpu")
    want = RM.anchors_of(size, stride, H, W, (0.5, 1.0, 2.0), "cpu")
    assert torch.equal(got, want)
    deltas = torch.from_numpy(np.random.RandomState(level).standard_normal(
        (len(got), 4)).astype(np.float32) * 3)
    for weights in (TMR.RPN_BOX_WEIGHTS, TMR.DET_BOX_WEIGHTS):
        assert torch.equal(TMR.decode_boxes(deltas, got, weights),
                           RM.decode(deltas, want, weights))


def grid_boxes(n, seed):
    """Boxes on a coarse integer grid: many equal boxes and IoUs exactly
    at 0.5 or 0.7, plus zero-area ones."""
    r = np.random.RandomState(seed)
    x1, y1 = r.randint(0, 6, n), r.randint(0, 6, n)
    w, h = r.randint(1, 6, n), r.randint(1, 6, n)
    w[::15] = 0
    return torch.tensor(np.stack([x1, y1, x1 + w, y1 + h], 1),
                        dtype=torch.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_nms_is_the_greedy_loop(seed, threshold):
    boxes = grid_boxes(90, seed)
    # three groups, the second with labels, as the proposals' and the
    # detections' calls use them; equal boxes tie on the order given
    labels = torch.from_numpy(
        np.random.RandomState(seed).randint(1, 4, 90).astype(np.int32))
    keep = N.nms(boxes, threshold, [(0, 30), (30, 40), (70, 20)],
                 labels=labels)
    want = torch.zeros(90, dtype=torch.bool)
    for a, c in [(0, 30), (30, 40), (70, 20)]:
        for lab in labels[a:a + c].unique().tolist():
            rows = a + torch.nonzero(labels[a:a + c] == lab)[:, 0]
            kept = RN.greedy_nms(boxes[rows], threshold)
            want[rows[kept]] = True
    assert torch.equal(keep, want)
    assert 0 < int(keep.sum()) < 90


def test_nms_exact_threshold_equal_scores_and_invalid():
    # IoU(0, 1) is exactly 0.5: not above, both kept; box 2 equals box 0
    # and comes later: suppressed; box 3 is invalid: neither kept nor
    # suppressing box 4, its copy
    boxes = torch.tensor([[0, 0, 4, 4], [0, 0, 4, 2], [0, 0, 4, 4],
                          [10, 10, 12, 12], [10, 10, 12, 12]],
                         dtype=torch.float32)
    valid = torch.tensor([True, True, True, False, True])
    assert float(N.iou(boxes[0], boxes[1:2])[0]) == 0.5
    keep = N.nms(boxes, 0.5, valid=valid)
    assert keep.tolist() == [True, True, False, False, True]
    assert N.nms(boxes, 0.49).tolist() == [True, False, False, True, False]


def _pyramid(seed, C=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((1, C, 40 // 2 ** l, 56 // 2 ** l), generator=g)
            for l in range(4)]


ROI_CASES = {
    # sides under 1 px (extent clamped to 1), a point box
    "under_1px": [[10.0, 12.0, 10.4, 12.3], [3.0, 3.0, 3.0, 3.0],
                  [100.0, 60.0, 100.9, 60.2]],
    # sqrt(area) / 224 + 1e-6 at and around 0.5, 1 and 2: the level changes
    "level_edges": [[0.0, 0.0, s, s] for base in (112.0, 224.0, 448.0)
                    for s in (base - 0.01, base - 224e-6, base, base + 0.01)],
    # partly and wholly off the map, and past its last row and column
    "off_map": [[-30.0, -20.0, 20.0, 10.0], [-80.0, -80.0, -10.0, -10.0],
                [200.0, 150.0, 260.0, 190.0], [215.0, 155.0, 300.0, 400.0],
                [-5.0, 40.0, 400.0, 44.0]],
}


@pytest.mark.parametrize("case", sorted(ROI_CASES))
@pytest.mark.parametrize("P", [7, 14])
def test_roi_align_edges_against_the_reference(case, P):
    feats = _pyramid(P)
    rois = torch.tensor(ROI_CASES[case], dtype=torch.float32)
    assert torch.equal(RA.roi_levels(rois), RR.levels(rois))
    got = RA.roi_align(feats, rois, P)
    want = RR.roi_align(feats, rois, P)
    scale = max(float(f.abs().max()) for f in feats)
    # the reference divides the extent by P where the port multiplies by
    # 1 / P: a sample moves by an ulp of its coordinate (up to 4e-6 here),
    # times the map's slope (a few times its magnitude)
    assert float((got - want).abs().max()) <= 2e-5 * scale
    if case == "off_map":
        assert float(got[1].abs().max()) == 0.0  # every sample off the map


def test_segmenter_in_the_scene_pipeline():
    from morefusion_tpu_torch import models as TM
    from morefusion_tpu_torch import runtime as TR
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.simulation import PlaneTypeSceneGeneration

    gen = PlaneTypeSceneGeneration(ProceduralModels(), n_object=2,
                                   random_state=np.random.RandomState(3))
    gen.generate()
    T = gen.random_camera_trajectory(4, 3)[0]
    f = gen.render_frame(T, shape=(120, 160), n_points_per_object=3000)
    node = TMR.MaskRCNNSegmentationNode(seeded(TMR.MaskRCNN),
                                        max_instances=4, device="cpu")
    torch.manual_seed(0)
    pose_model = TM.tiny_singleview3d(21, n_point=32, with_occupancy=True,
                                      voxel_dim=16)
    pipe = TR.ScenePipeline(pose_model, ProceduralModels(), segmenter=node,
                            voxel_dim=16, n_votes=1, native_mapping=False,
                            size_filter=False, device="cpu")
    label, classes = node(f["rgb"], f["depth"])
    assert classes and (label > 0).any()
    poses = pipe.process_frame(f["rgb"], f["depth"], f["intrinsic_matrix"],
                               f["T_cam2world"], refine=False)
    assert isinstance(poses, dict) and poses
    for result in poses.values():
        assert np.isfinite(result["T_cad2cam"]).all()
