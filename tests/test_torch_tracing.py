"""The port's spans and counters (``utils/profiling.py``: ``annotate``,
``count``, ``recorded``) in the train step, the models and the pose node,
on the CPU at a tiny size:

- with no profiler running, ``annotate`` hands back one shared null
  context, and a SingleView3D (occupancy) train step, a PoseNet train step
  and a pose-node frame record nothing;
- under ``torch.profiler.profile`` every span is in the profile, each
  child's range inside its parent's;
- ``recorded()`` holds one interval per span call and the node's counters,
  and a later traced stretch does not see an earlier one's;
- the loss, the gradients, the parameters after one Adam step and the
  node's poses and confidences are bit for bit the same traced and not.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.runtime import pose_estimation as TP
from morefusion_tpu_torch.training import trainer as TT
from morefusion_tpu_torch.utils import profiling

torch.set_num_threads(2)

N_CLASS, N_POINT, S, V = 21, 32, 48, 32
STEP_CHILDREN = ("trainer.unpack", "trainer.augment", "trainer.forward",
                 "trainer.loss", "trainer.backward", "trainer.optimizer")
# in the order a frame runs them: the one copy, then the selection on the
# device's copy of the frame
NODE_SPANS = ("pose_node.upload", "pose_node.select", "pose_node.predict",
              "pose_node.resolve")
MODEL_SPANS = {"singleview3d": ("model.backbone", "model.voxel",
                                "model.heads"),
               "posenet": ("model.backbone", "model.heads")}


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _bank(seed=0):
    g = torch.Generator().manual_seed(seed)
    n = 64
    points = torch.rand((N_CLASS + 1, 100, 3), generator=g) * 0.1 - 0.05
    points[0] = 0
    symmetric = torch.zeros(N_CLASS + 1, dtype=torch.bool)
    symmetric[1::3] = True
    return TT.CadPointBank(
        points=points, symmetric=symmetric,
        solid_points=torch.rand((N_CLASS + 1, n, 3), generator=g) * 0.1
        - 0.05,
        solid_sdf=torch.rand((N_CLASS + 1, n), generator=g) * 0.01,
        solid_mask=torch.rand((N_CLASS + 1, n), generator=g) < 0.8)


def _batch(seed=0, B=2):
    rng = np.random.RandomState(seed)
    pcd = rng.uniform(-0.08, 0.08, (B, S, S, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    pcd[rng.rand(B, S, S) < 0.3] = np.nan
    q = rng.normal(size=(B, 4)).astype(np.float32)
    pitch = np.full(B, 0.01, np.float32)
    return dict(
        class_id=np.array([13, 2], np.int32)[:B],
        rgb=rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32),
        pcd=pcd,
        quaternion_true=q / np.linalg.norm(q, axis=1, keepdims=True),
        translation_true=np.float32(rng.uniform(-0.02, 0.02, (B, 3))
                                    + [0, 0, 0.8]),
        origin=np.float32(np.array([0, 0, 0.8]) - pitch[:, None] * 15.5),
        pitch=pitch,
        grid_target=(rng.rand(B, V, V, V) < 0.2).astype(np.float32),
        grid_nontarget_empty=(rng.rand(B, V, V, V) < 0.3).astype(np.float32),
    )


def _model(kind):
    torch.manual_seed(0)
    if kind == "singleview3d":
        return TM.tiny_singleview3d(N_CLASS, n_point=N_POINT,
                                    with_occupancy=True)
    return TM.PoseNet(n_fg_class=N_CLASS, n_point=N_POINT, backbone_width=8,
                      psp_bottleneck=32, psp_up=(16, 8, 8),
                      tower_widths=(32, 16, 8))


def _train_step(kind):
    """A fresh model and train state; ``run()`` does one step (augmentation
    on) and returns the loss, the gradients and the parameters after it."""
    model = _model(kind)
    state = TT.create_train_state(model)
    step = TT.make_train_step(model, _bank(), augment=True)
    batch = _batch()

    def run():
        _, metrics = step(state, batch, True, seed=7)
        return (metrics["loss"].clone(),
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    return run


H, W = 60, 80
IDS = np.array([3, 7, 9], np.int32)
BBOXES = np.array([[5, 10, 30, 50], [35, 20, 55, 35], [20, 55, 40, 78]])


def _frame_call():
    """A node over a tiny SingleView3D; ``run()`` estimates one frame of 3
    instances (padded to 4 lanes) and returns its poses and confidences."""
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    pcd = rng.uniform(-0.1, 0.1, (H, W, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    pcd[rng.rand(H, W) < 0.1] = np.nan
    label = np.zeros((H, W), np.int32)
    for i, (y1, x1, y2, x2) in zip(IDS, BBOXES):
        label[y1:y2, x1:x2] = i
    inst = {3: 2, 7: 5, 9: 8}
    grids = {3: rng.rand(V, V, V).astype(np.float32)}
    torch.manual_seed(0)
    model = TM.tiny_singleview3d(10, n_point=16, with_occupancy=True)
    node = TP.PoseEstimationNode(model, lambda v, c: 0.004 + 0.001 * c,
                                 image_size=S, device="cpu")

    def run():
        out = node.estimate(rgb, pcd, label, inst, grids)
        return ({i: r["T_cad2cam"] for i, r in out.items()},
                {i: r["confidence"] for i, r in out.items()})

    return run


CALLS = {"singleview3d": lambda: _train_step("singleview3d"),
         "posenet": lambda: _train_step("posenet"),
         "node": _frame_call}


def _spans_of(kind):
    if kind == "node":
        return NODE_SPANS + MODEL_SPANS["singleview3d"]
    return ("trainer.step",) + STEP_CHILDREN + MODEL_SPANS[kind]


def _ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if getattr(e, "is_user_annotation", False)
            and e.device_type != DeviceType.CUDA]


def test_annotate_is_one_null_context_with_no_profiler():
    a, b = profiling.annotate("a"), profiling.annotate("b")
    assert a is b
    with a as entered:
        assert entered is None


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_untraced_calls_record_nothing(kind, monkeypatch):
    run = CALLS[kind]()
    with _profiler():  # a traced stretch first, so that there is a record
        run()
    before = profiling.recorded()

    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler running")

    monkeypatch.setattr(profiling.torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_mark", refuse)
    run()
    run()
    assert profiling.recorded() == before


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_traced_call_holds_every_span_nested(kind):
    run = CALLS[kind]()
    run()  # untraced: the traced call below begins a new stretch
    with _profiler() as prof:
        run()
    ranges = _ranges(prof)
    names = [n for n, _, _ in ranges]
    for span in _spans_of(kind):
        assert names.count(span) == 1, (span, names)
    at = {n: (a, b) for n, a, b in ranges}

    def inside(child, parent):
        (a, b), (pa, pb) = at[child], at[parent]
        assert pa <= a <= b <= pb, (child, parent)

    if kind == "node":
        starts = [at[n][0] for n in NODE_SPANS]
        assert starts == sorted(starts)
        for span in MODEL_SPANS["singleview3d"]:
            inside(span, "pose_node.predict")
    else:
        for span in STEP_CHILDREN:
            inside(span, "trainer.step")
        for span in MODEL_SPANS[kind]:
            inside(span, "trainer.forward")
    # the record holds one interval per span call, each of its length
    rec = profiling.recorded()
    assert sorted(rec["device_ms"]) == sorted(_spans_of(kind))
    for span in _spans_of(kind):
        (ms,) = rec["device_ms"][span]
        a, b = at[span]
        assert 0 <= ms <= (b - a) * 1e-3 + 1.0


def test_node_counts_instances_and_lanes_per_stretch():
    """A stretch begins at the first span or count that sees a profiler
    after one that saw none: the calls of one stretch add up, and an
    untraced call ends it."""
    node_frame, posenet_step = _frame_call(), _train_step("posenet")
    node_frame()
    with _profiler():
        node_frame()
        node_frame()
    rec = profiling.recorded()
    # and PSPNet's seven resizes a forward (ops/resize.py)
    # (the CPU node selects with the plain version: no pose_node.select_kernel)
    assert rec["counters"] == {"pose_node.frames": 2,
                               "pose_node.instances": 6,
                               "pose_node.lanes": 8, "resize.calls": 14}
    assert all(len(rec["device_ms"][n]) == 2 for n in NODE_SPANS)
    node_frame()
    with _profiler():
        node_frame()
    assert profiling.recorded()["counters"] == {"pose_node.frames": 1,
                                                "pose_node.instances": 3,
                                                "pose_node.lanes": 4,
                                                "resize.calls": 7}
    posenet_step()
    with _profiler():
        posenet_step()
    rec = profiling.recorded()
    assert rec["counters"] == {"resize.calls": 7}
    assert sorted(rec["device_ms"]) == sorted(_spans_of("posenet"))


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_outputs_are_bit_identical_traced_and_not(kind):
    untraced = CALLS[kind]()()
    with _profiler():
        traced = CALLS[kind]()()
    for a, b in zip(untraced, traced):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
            continue
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
            else:
                np.testing.assert_array_equal(a[k], b[k])
