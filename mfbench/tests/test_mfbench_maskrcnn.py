"""The cell ``maskrcnn_r50_fpn.serve.seg1`` end to end at a tiny size on the
CPU (narrow widths, a 96 x 128 frame, a few dozen proposals), traced and
not, and the import guard over its reference files and readers: no
torchvision, no JAX, nothing of the port."""

import ast
import copy

import pytest
import torch

from mfbench import counts_maskrcnn, harness
from mfbench.tests import tiny
from mfbench.tests.test_mfbench_imports import top_level_imports

NAME = "maskrcnn_r50_fpn.serve.seg1"
TINY_KWARGS = dict(width=8, fpn_channels=16, representation=32,
                   mask_channels=16, min_size=160, max_size=266,
                   rpn_pre_nms_top_n=50, rpn_post_nms_top_n=40,
                   box_candidates=60)
NEW_METRICS = {"maskrcnn.backbone_ms_p50", "maskrcnn.rpn_ms_p50",
               "maskrcnn.box_ms_p50", "maskrcnn.mask_ms_p50",
               "roi_align.roofline.seg", "nms.roofline.seg", "maskrcnn.mfu"}


def tiny_cell():
    cell = copy.deepcopy(harness.load_cell(tiny.ROOT, NAME))
    cell.config["kwargs"].update(TINY_KWARGS)
    cell.spec["params"].update(image_shape=[96, 128], pool_frames=2,
                               check_frames=2, warmup_frames=2,
                               trace_units=[1, 2])
    return cell


def run(trace, seed=2**31 + 5, seconds=0.5):
    torch.set_num_threads(2)
    return harness.execute(tiny.ROOT, NAME, seed, seconds, trace,
                           torch.device("cpu"), cell=tiny_cell())


def test_cell_runs_tiny_on_the_cpu():
    result, checks = run(trace=False)
    assert result["correct"], checks
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    limits = harness.load_cell(tiny.ROOT, NAME).limits
    assert {n for n, _, _ in checks} == set(limits)
    gaps = dict((n, v) for n, v, _ in checks)
    assert gaps["proposals"] < float("inf") > gaps["detections"]


def test_traced_run_reads_the_new_metrics():
    result, _ = run(trace=True, seconds=1.0)
    assert result["correct"]
    got = set(result["metrics"])
    # no device trace on the CPU: the kernels' rooflines read nothing
    assert got == NEW_METRICS - {"roi_align.roofline.seg",
                                 "nms.roofline.seg"}
    for name in got:
        assert result["metrics"][name]["value"] > 0


def test_a_wrong_detection_fails_the_check(monkeypatch):
    """Dropping the best detection of every frame moves the detections'
    indices: the check reads inf there."""
    from morefusion_tpu_torch.models import maskrcnn

    select = maskrcnn.MaskRCNN.select_detections

    def shifted(self, *args):
        out = select(self, *args)
        out["index"] = out["index"].roll(1)
        return out

    monkeypatch.setattr(maskrcnn.MaskRCNN, "select_detections", shifted)
    result, checks = run(trace=False)
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in checks)["detections"] == float("inf")


def test_work_counts():
    """A RoI inside one level reads its taps' rows x columns once, and
    RoIs that overlap read the elements they share once; NMS counts each
    pair of a group once."""
    levels = [(200, 272), (100, 136), (50, 68), (25, 34)]
    ops, nbytes = counts_maskrcnn.roi_align_work(
        [[0.0, 0.0, 56.0, 56.0]], levels, 256, 7)
    # 56 px on P2 (stride 4): 14 samples a side at 0.5 + k, taps 0..14
    assert nbytes == 4 * (15 * 15 * 256 + 4 + 256 * 49)
    assert ops == 256 * 49 * 49
    # the same RoI twice, and one 4 px (a P2 element) to the right: taps
    # 0..14 and 1..15 a row, 15 x 16 elements in all
    ops, nbytes = counts_maskrcnn.roi_align_work(
        [[0.0, 0.0, 56.0, 56.0], [0.0, 0.0, 56.0, 56.0],
         [4.0, 0.0, 60.0, 56.0]], levels, 256, 7)
    assert nbytes == 4 * (15 * 16 * 256 + 3 * 4 + 3 * 256 * 49)
    assert ops == 3 * 256 * 49 * 49
    ops, nbytes = counts_maskrcnn.nms_work([1000, 663])
    assert ops == counts_maskrcnn.IOU_FLOPS * (1000 * 999 // 2
                                               + 663 * 662 // 2)


NEW_FILES = ["reference/models/maskrcnn.py", "reference/ops/roi_align.py",
             "reference/ops/nms.py", "drivers/segment_frame.py",
             "counts_maskrcnn.py"]


@pytest.mark.parametrize("path", NEW_FILES)
def test_new_files_import_no_torchvision_jax_or_port(path):
    file = tiny.ROOT / "mfbench" / path
    names = set(top_level_imports(file))
    assert not names & {"torchvision", "jax", "jaxlib", "flax", "optax",
                        "morefusion_tpu"}
    if path.startswith("reference"):
        assert "morefusion_tpu_torch" not in names
    ast.parse(file.read_text())
