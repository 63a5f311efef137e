"""The pose node's selection of the instances it poses
(``ops/instance_boxes.py``, ``csrc/instance_boxes.cu``) and its staged
``dispatch`` (``runtime/pose_estimation.py``):

- the plain version equals the host rule the node had before the kernel
  (``masks_to_bboxes`` of ``label == id``, and whether any of its pixels
  has a cloud point with no NaN component) on random label images and on
  an instance with no pixel, one whose every point is NaN, a one-pixel
  instance, boxes touching each border, ids that are not contiguous and
  ids absent from the label;
- ``PoseEstimationNode.estimate`` on the CPU gives the same instances and
  bit for bit the same poses and confidences as a copy of the node's
  former host ``dispatch`` kept here, on the benchmark generator's frames
  of 5-8 objects and on one with an instance whose every point is NaN;
- on the card (``-m cuda``; each test skips without one): the kernel
  equals the plain version bit for bit on the same cases, at the serving
  cell's 480 x 640; the node gives the former dispatch's poses, also with
  each frame dispatched before the last is resolved; ``dispatch`` returns
  while work queued earlier on the current stream still runs, and
  ``resolve`` then gives the former dispatch's poses.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_pose_select.py -m cuda``.
"""

import time

import numpy as np
import pytest
import torch

from mfbench import generators
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.geometry import masks_to_bboxes
from morefusion_tpu_torch.ops import instance_boxes as IB
from morefusion_tpu_torch.runtime import pose_estimation as TP

torch.set_num_threads(2)

V = 32  # the node's voxel grid a side
H, W = 480, 640  # the serving cell's frames


def host_rule(label, pcd, ids):
    """The node's former host selection: ``(K, 5)`` int64 of each id's box
    and its count of pixels with a finite point."""
    finite = ~np.isnan(pcd).any(axis=2)
    out = np.zeros((len(ids), 5), np.int64)
    for k, ins_id in enumerate(ids):
        mask = label == ins_id
        out[k, :4] = masks_to_bboxes(mask).round().astype(int)
        out[k, 4] = (mask & finite).sum()
    return out


def random_case(seed, h=H, w=W):
    """Rectangles and ellipses of 9 ids over a background, 30% holes."""
    r = np.random.RandomState(seed)
    label = np.zeros((h, w), np.int32)
    for ins_id in range(1, 10):
        y, x = r.randint(0, h), r.randint(0, w)
        a = r.randint(1, max(2, h // 3))
        b = r.randint(1, max(2, w // 3))
        if ins_id % 2:
            label[max(0, y - a):y + a, max(0, x - b):x + b] = ins_id
        else:
            v, u = np.mgrid[0:h, 0:w]
            label[((v - y) / a) ** 2 + ((u - x) / b) ** 2 < 1] = ins_id
    pcd = r.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    holes = r.rand(h, w, 3) < 0.1  # a NaN in any one component is a hole
    pcd[holes] = np.nan
    return label, pcd, np.arange(1, 10, dtype=np.int32)


def edge_case(h=H, w=W):
    """The edge cases of the contract, in one frame."""
    r = np.random.RandomState(7)
    label = np.zeros((h, w), np.int32)
    pcd = r.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    label[0:5, 0:7] = 11  # the top-left corner
    label[h - 3:h, w - 9:w] = 4  # the bottom-right corner
    label[0, w - 1] = 4  # and one pixel at the top-right: a frame-tall box
    label[h // 2, w // 2] = 1000  # one pixel
    label[h - 1, 3:40] = 1001  # the bottom row
    label[10:20, w - 1] = 1002  # the right column
    label[100:140, 200:260] = 77  # every point NaN, one component each
    pcd[100:120, 200:260, 0] = np.nan
    pcd[120:140, 200:230, 1] = np.nan
    pcd[120:140, 230:260, 2] = np.nan
    label[300:310, 300:400] = -5  # a negative id
    # 9 and 12 have no pixel; 0 is the background's
    ids = np.array([11, 4, 9, 1000, 1001, 1002, 77, 12, -5, 0], np.int32)
    return label, pcd, ids


CASES = {f"random{s}": (lambda s=s: random_case(s)) for s in range(4)}
CASES["edges"] = edge_case
CASES["small"] = lambda: random_case(11, 7, 5)


def _tensors(label, pcd, ids, device="cpu"):
    return (torch.from_numpy(label).to(device),
            torch.from_numpy(pcd).to(device),
            torch.from_numpy(ids).to(device))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_the_host_rule(case):
    label, pcd, ids = CASES[case]()
    got = IB.instance_boxes_plain(*_tensors(label, pcd, ids))
    assert got.dtype == torch.int32 and got.shape == (len(ids), 5)
    np.testing.assert_array_equal(got.numpy(), host_rule(label, pcd, ids))


def test_edge_case_readings():
    label, pcd, ids = edge_case()
    got = dict(zip(ids.tolist(),
                   IB.instance_boxes_plain(*_tensors(label, pcd, ids))
                   .tolist()))
    assert got[9] == got[12] == [0, 0, 0, 0, 0]
    assert got[4][:4] == [0, W - 9, H, W]
    assert got[1000] == [H // 2, W // 2, H // 2 + 1, W // 2 + 1, 1]
    assert got[77] == [100, 200, 140, 260, 0]
    # the node keeps an instance iff it has a finite point, and then its box
    # has an area
    rule = host_rule(label, pcd, ids)
    for k, row in enumerate(rule):
        assert (row[4] > 0) <= ((row[2] - row[0]) * (row[3] - row[1]) > 0)


def test_plain_checks_its_arguments():
    label, pcd, ids = edge_case(8, 8)
    t = _tensors(label, pcd, ids)
    with pytest.raises(ValueError, match="label must be int32"):
        IB.instance_boxes(t[0].long(), t[1], t[2])
    with pytest.raises(ValueError, match="pcd must be float32"):
        IB.instance_boxes(t[0], t[1].double(), t[2])
    with pytest.raises(ValueError, match="ids must be int32"):
        IB.instance_boxes(t[0], t[1], t[2].long())


class FormerNode(TP.PoseEstimationNode):
    """The node's ``dispatch`` and ``resolve`` before the selection moved to
    the device: host masks, boxes and finite test, nine pageable copies."""

    def dispatch(self, rgb, pcd, instance_label, instance_to_class,
                 noentry_grids=None, sample_indices=None):
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
                g = (np.clip(g, 0.0, 1.0) * 255.0).round().astype(np.uint8)
            grids.append(g)
        if not ids:
            return None
        B = len(ids)
        take = list(range(B)) + [0] * ((1 << (B - 1).bit_length()) - B)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        dev = self._device

        def put(a, dtype=None):
            a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
            return torch.from_numpy(a).to(dev)

        idx = None
        if sample_indices is not None:
            idx = put(np.stack([sample_indices[ids[k]] for k in take]),
                      np.int64)
        T, conf = self._predict_frame(
            put(rgb), put(pcd, np.float32), put(instance_label, np.int32),
            put(np.asarray(ids, np.int32)[take]),
            put(np.asarray(bboxes, np.int64)[take]),
            put(np.asarray(class_ids, np.int64)[take]),
            put(np.asarray(pitches, np.float32)[take]),
            put(np.stack(grids)[take]), idx)
        return dict(T=T, conf=conf, ids=ids, class_ids=class_ids, B=B)

    def resolve(self, handle):
        if handle is None:
            return {}
        B = handle["B"]
        Ts = handle["T"].cpu().numpy().astype(np.float64)[:B]
        confs = handle["conf"].cpu().numpy()[:B]
        return {ins: dict(T_cad2cam=Ts[k],
                          class_id=int(handle["class_ids"][k]),
                          confidence=float(confs[k]))
                for k, ins in enumerate(handle["ids"])}


def frames(h, w):
    """The benchmark generator's frames of 5, 6, 7 and 8 objects with their
    no-entry grids, and the 8-object frame again with its second instance's
    every point NaN (the node leaves it out)."""
    bank = {k: v.numpy() for k, v in
            generators.cad_bank(5, [], "cpu", max_solid=16).items()}
    out = []
    for i, n in enumerate((5, 6, 7, 8)):
        f = generators.scene_frame(5, i, bank, h, w, n, V, 0.3)
        out.append((f["rgb"], f["pcd"], f["label"], f["instance_to_class"],
                    dict(zip(f["instance_to_class"], f["noentry"]))))
    rgb, pcd, label, classes, grids = out[-1]
    pcd = pcd.copy()
    pcd[label == 2] = np.nan
    out.append((rgb, pcd, label, classes, grids))
    return out


def _nodes(device, S=32):
    torch.manual_seed(0)
    model = TM.tiny_singleview3d(22, n_point=16, with_occupancy=True)

    def pitch(v, c):
        return 0.004 + 0.001 * c

    return (TP.PoseEstimationNode(model, pitch, image_size=S, voxel_dim=V,
                                  device=device),
            FormerNode(model, pitch, image_size=S, voxel_dim=V,
                       device=device))


def assert_same_poses(got, want):
    assert list(got) == list(want)
    for ins in want:
        assert got[ins]["class_id"] == want[ins]["class_id"]
        assert got[ins]["T_cad2cam"].dtype == np.float64
        np.testing.assert_array_equal(got[ins]["T_cad2cam"],
                                      want[ins]["T_cad2cam"])
        assert got[ins]["confidence"] == want[ins]["confidence"]


def test_node_equals_the_former_host_dispatch():
    node, former = _nodes("cpu")
    for k, (rgb, pcd, label, classes, grids) in enumerate(frames(120, 160)):
        got = node.estimate(rgb, pcd, label, classes, grids)
        want = former.estimate(rgb, pcd, label, classes, grids)
        assert_same_poses(got, want)
        assert len(got) == (len(classes) if k < 4 else len(classes) - 1)


def test_node_equals_the_former_dispatch_with_given_pixels():
    node, former = _nodes("cpu")
    rgb, pcd, label, classes, grids = frames(120, 160)[-1]
    r = np.random.RandomState(3)
    idx = {ins: r.randint(0, 32 * 32, 16) for ins in classes}
    # float grids and an instance that is not in the frame
    grids = {ins: g.astype(np.float32) / 255.0 for ins, g in grids.items()}
    classes = {**classes, 50: 3}
    got = node.estimate(rgb, pcd, label, classes, grids, idx)
    want = former.estimate(rgb, pcd, label, classes, grids, idx)
    assert_same_poses(got, want)
    assert 50 not in got
    assert node.dispatch(rgb, pcd, label, {}) is None
    assert node.dispatch(rgb, pcd, label, {50: 3}) is None


def test_device_constant_is_made_once():
    from morefusion_tpu_torch.utils.constants import device_constant

    a = device_constant((0.1, 0.2, 0.3), torch.float32, "cpu")
    assert a is device_constant(np.float64([0.1, 0.2, 0.3]), torch.float32,
                                torch.device("cpu"))
    assert torch.equal(a, torch.tensor([0.1, 0.2, 0.3]))
    corners = ((0, 0, 1), (1, 1, 0))
    assert torch.equal(device_constant(corners, torch.int64, "cpu"),
                       torch.tensor(corners))
    with torch.inference_mode():
        assert not device_constant((7, 8), torch.int64, "cpu").is_inference()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain(case):
    device = _card()
    label, pcd, ids = CASES[case]()
    want = IB.instance_boxes_plain(*_tensors(label, pcd, ids))
    args = _tensors(label, pcd, ids, device)
    launches = IB.instance_boxes.launches
    for _ in range(2):
        got = IB.instance_boxes(*args)
        assert got.device == device
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert IB.instance_boxes.launches == launches + 2


@pytest.mark.cuda
def test_kernel_splits_many_ids():
    device = _card()
    label, pcd, _ = random_case(5)
    ids = np.arange(-600, 2000, dtype=np.int32)  # three launches of 1024
    want = IB.instance_boxes_plain(*_tensors(label, pcd, ids))
    got = IB.instance_boxes(*_tensors(label, pcd, ids, device))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def _sleep_cycles(ms):
    """``torch.cuda._sleep``'s cycles for about ``ms`` at the card's
    present clock (warmed first: an idle card starts at a low clock)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
    return int(10_000_000 * ms / start.elapsed_time(end))


@pytest.mark.cuda
def test_node_equals_the_former_dispatch_on_the_card():
    device = _card()
    node, former = _nodes(device)
    # the voxelization's index_add_ sums in a fixed order
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for k, (rgb, pcd, label, classes, grids) in enumerate(frames(H, W)):
            launches = IB.instance_boxes.launches
            got = node.estimate(rgb, pcd, label, classes, grids)
            # the boxes came from one launch of the kernel
            assert IB.instance_boxes.launches == launches + 1
            assert_same_poses(got,
                              former.estimate(rgb, pcd, label, classes, grids))
            assert len(got) == (len(classes) if k < 4 else len(classes) - 1)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_dispatch_ahead_of_resolve_on_the_card():
    """As the scene pipeline runs it: each frame dispatched before the one
    before it is resolved, so a frame's copy and boxes are made while the
    other frame's forward is in flight."""
    device = _card()
    node, former = _nodes(device)
    pool = frames(H, W)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = [former.estimate(*f) for f in pool * 2]
        handles, got = [], []
        for f in pool * 2:
            handles.append(node.dispatch(*f))
            if len(handles) == 2:
                got.append(node.resolve(handles.pop(0)))
        got.append(node.resolve(handles.pop(0)))
    finally:
        torch.use_deterministic_algorithms(False)
    for g, w in zip(got, want):
        assert_same_poses(g, w)


@pytest.mark.cuda
def test_dispatch_does_not_wait_for_the_stream():
    device = _card()
    node, former = _nodes(device)
    rgb, pcd, label, classes, grids = frames(H, W)[-2]
    want = former.estimate(rgb, pcd, label, classes, grids)
    node.estimate(rgb, pcd, label, classes, grids)
    # dispatch's own enqueue of this forward takes 15-25 ms of the card's
    # host: a sleep of ~200 ms leaves room to tell waiting from not
    cycles = _sleep_cycles(200.0)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)  # holds the current stream for ~200 ms
    end.record()
    t0 = time.perf_counter()
    handle = node.dispatch(rgb, pcd, label, classes, grids)
    took = (time.perf_counter() - t0) * 1e3
    still_busy = not end.query()
    got = node.resolve(handle)
    slept = start.elapsed_time(end)
    assert still_busy and took < slept / 2, (
        f"dispatch took {took:.1f} ms behind a sleep of {slept:.1f} ms")
    # the same instances and boxes; the forward's atomic sums may round
    # otherwise from run to run
    assert list(got) == list(want)
    for ins in want:
        np.testing.assert_allclose(got[ins]["T_cad2cam"],
                                   want[ins]["T_cad2cam"], rtol=0, atol=1e-5)
        assert abs(got[ins]["confidence"] - want[ins]["confidence"]) < 1e-5
