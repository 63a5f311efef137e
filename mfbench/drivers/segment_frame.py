"""The ``segment_frame`` driver: one client (a robot's camera) in a closed
loop with Mask R-CNN (``models/maskrcnn.py::MaskRCNNSegmentationNode``),
handing over the next frame of a pool as soon as the last frame's instance
image and classes are on the host.

A frame: the node on the frame's RGB, keeping as many detections as the
frame has objects (the published node keeps one instance a class above a
score of 0.75; random weights score near 1/22). It is timed from its
hand-over to its results on the host.

Set-up makes the weights on the device from the seed (each frozen
BatchNorm's statistics too, :func:`frozen_bn`), the pool of frames on the
host (the pose cell's: ``generators.scene_frame``, 5 to 8 objects), builds
the node and serves the pool's first frames (every object count, so every
shape). The check (after the window): ``check_frames`` window frames drawn
from the seed, with the frame of most objects among them. Each is run once
more through the node with its stages kept, and the plain reference
(``mfbench/reference/models/maskrcnn.py``, float32, TF32 off) follows it
stage by stage:

- ``features``: P2-P6 from the frame, the largest gap of a level over the
  level's largest magnitude;
- ``rpn``: the objectness and deltas of every level, alike;
- ``proposals``: the reference's selection run on the program's RPN
  outputs: the kept proposals' anchor indices identical (else inf), then
  the largest gap of their boxes in pixels;
- ``box``: the box head on the program's proposals: the class logits and
  deltas of the kept ones, over their largest magnitude;
- ``detections``: the reference's selection run on the program's head
  outputs: the detections' pair indices identical (else inf), then the
  largest gap of their boxes in pixels;
- ``mask``: the mask head on the program's detections: the class channel's
  28 x 28 logits, over their largest magnitude;
- ``pixels``: the reference's instance image, pasted from its masks at the
  program's detections, against the window's and the re-run's: the larger
  share of pixels that differ.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mfbench import counts_maskrcnn, generators
from mfbench.drivers import serve_frame
from mfbench.drivers import train_step as common

BN_STREAM = 40


@dataclasses.dataclass
class State:
    node: object
    frames: list
    # per pool frame, the distinct answers the window gave:
    # [(label as uint8, classes)]
    distinct: dict = dataclasses.field(default_factory=dict)
    answers: list = dataclasses.field(default_factory=list)  # (frame, j)
    image_hw: tuple = ()
    # per traced frame, (unit, the node's ``last``): its boxes stay on the
    # device until the window has closed
    traced: list = dataclasses.field(default_factory=list)


def frozen_bn(model, seed):
    """Each frozen BatchNorm (a module with ``running_var``), by name: weight
    U(0.6, 1.2), bias U(-0.1, 0.1), mean U(-0.1, 0.1), variance U(0.5,
    1.5), drawn from the seed, so that activations stay O(1) through
    ResNet-50 (the seed's +-0.01 vectors would shrink them ~100x a
    stage)."""
    mods = sorted((n, m) for n, m in model.named_modules()
                  if hasattr(m, "running_var"))
    device = mods[0][1].running_var.device
    g = generators.device_generator(seed, BN_STREAM, device)
    with torch.no_grad():
        for _, m in mods:
            u = torch.rand((4, m.running_var.numel()), generator=g,
                           device=device)
            m.weight.copy_(0.6 + 0.6 * u[0])
            m.bias.copy_(0.2 * u[1] - 0.1)
            m.running_mean.copy_(0.2 * u[2] - 0.1)
            m.running_var.copy_(0.5 + u[3])
    return model


def build(ctx, package, device):
    model = common.build_model(ctx.cell.config, package, device)
    return frozen_bn(generators.load_weights(model, ctx.seed), ctx.seed)


def make_frames(ctx):
    bank = generators.cad_bank(ctx.seed, (), ctx.device)
    host = {k: bank[k].cpu().numpy() for k in ("half_extent", "diagonal")}
    return serve_frame.make_frames(ctx, host)


def n_objects(frame):
    return len(frame["instance_to_class"])


def setup(ctx):
    from morefusion_tpu_torch.models.maskrcnn import (
        MaskRCNNSegmentationNode,
    )

    common.set_precision(ctx.cell.config)
    frames = make_frames(ctx)
    node = MaskRCNNSegmentationNode(
        build(ctx, "morefusion_tpu_torch", ctx.device), device=ctx.device)
    st = State(node=node, frames=frames)
    for i in range(ctx.cell.params["warmup_frames"]):
        frame = frames[i % len(frames)]
        node(frame["rgb"], max_instances=n_objects(frame))
    H, W = ctx.cell.params["image_shape"]
    st.image_hw = node.model.padded_size(*node.model.resized_size(H, W))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return st


def keep_answer(st, i, label, classes):
    """Index of the answer among frame ``i``'s distinct ones."""
    seen = st.distinct.setdefault(i, [])
    for j, (lab, cls) in enumerate(seen):
        if cls == classes and np.array_equal(lab, label):
            return j
    seen.append((label.astype(np.uint8), classes))
    return len(seen) - 1


def frame_work(st, last):
    """The kernels' work in a frame the node served (its ``last``): the
    box and mask RoIAlign calls, the proposals' and detections' NMS."""
    model = st.node.model
    Hp, Wp = st.image_hw
    level_hw = [(-(-Hp // s), -(-Wp // s)) for s in counts_maskrcnn.STRIDES]
    C = model.fpn.layer_blocks[0].out_channels
    return {
        "roi_align": [
            counts_maskrcnn.roi_align_work(last["proposals"].cpu().numpy(),
                                           level_hw, C, model.box_pool),
            counts_maskrcnn.roi_align_work(last["detections"].cpu().numpy(),
                                           level_hw, C, model.mask_pool)],
        "nms": [
            counts_maskrcnn.nms_work([n for _, n in last["proposal_groups"]]),
            counts_maskrcnn.nms_work([last["candidates"]], labels=True)]}


def window(st, ctx, seconds):
    rec = ctx.record
    tr = ctx.tracer
    first = ctx.cell.params["warmup_frames"]
    t_start = time.perf_counter()
    deadline = t_start + seconds
    k = 0
    while True:
        i = (first + k) % len(st.frames)
        frame = st.frames[i]
        n = n_objects(frame)
        with tr.unit(k):
            t0 = time.perf_counter()
            with tr.span("segment.frame"):
                label, classes = st.node(frame["rgb"], max_instances=n)
            t1 = time.perf_counter()
        ok = len(classes) == n
        traced = tr.enabled and tr.start <= k < tr.start + tr.count
        rec.units.append({"start": t0, "end": t1, "size": 1, "ok": ok,
                          "instances": n, "frame": i, "work": {}})
        if traced:
            st.traced.append((len(rec.units) - 1, st.node.last))
        rec.failed += 0 if ok else 1
        st.answers.append((i, keep_answer(st, i, label, classes)))
        k += 1
        if time.perf_counter() >= deadline:
            break
    rec.window_s = time.perf_counter() - t_start
    # the traced frames' work, read back once their stretch has ended, so
    # that the profile holds the node's own work alone
    for u, last in st.traced:
        rec.units[u]["work"] = frame_work(st, last)
    st.traced = []
    rec.extra["frame_flops"] = lambda: counts_maskrcnn.frame_flops(
        ctx.cell.config, st.image_hw,
        ctx.cell.config["kwargs"]["rpn_post_nms_top_n"])


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x


def answers(st, ctx):
    """The sampled frames' window answers, and each frame run once more
    with its stages kept, on the host; then the program is freed."""
    units = ctx.record.units
    got = []
    for u in serve_frame.sample(ctx, units):
        i, j = st.answers[u]
        frame = st.frames[i]
        out = st.node.run(frame["rgb"], max_instances=n_objects(frame),
                          stages=True)
        answer = _host({k: out[k] for k in (
            "features", "objectness", "deltas", "cls_logits", "box_deltas",
            "mask_logits")})
        answer["proposals"] = _host({k: out["proposals"][k] for k in (
            "boxes", "valid", "index")})
        answer["detections"] = _host({k: out["detections"][k] for k in (
            "boxes", "classes", "valid", "index")})
        answer["labels"] = [st.distinct[i][j][0].astype(np.int32),
                            out["label"]]
        got.append((i, answer))
    st.node = None
    st.distinct = {}
    st.answers = []
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def _own_answer(model, feats, hw, k, H, W):
    """The reference's own answers for a frame from its features, in the
    program's form."""
    objectness, deltas = model.rpn(feats)
    props = model.proposals(objectness, deltas, model.anchors(feats), hw)
    n = len(props["boxes"])
    cls_logits, box_deltas = model.box_outputs(feats, props["boxes"])
    valid = torch.ones(n, dtype=torch.bool, device=props["boxes"].device)
    dets = model.detections(props["boxes"], valid, cls_logits, box_deltas,
                            k, hw)
    logits = model.mask_logits(feats, dets["boxes"], dets["classes"])
    label = model.paste(logits, dets["boxes"], hw, H, W)
    m = len(dets["boxes"])
    return _host(dict(
        features=feats, objectness=objectness, deltas=deltas,
        cls_logits=cls_logits, box_deltas=box_deltas, mask_logits=logits,
        proposals=dict(boxes=props["boxes"], index=props["index"],
                       valid=valid),
        detections=dict(boxes=dets["boxes"], classes=dets["classes"],
                        index=dets["index"],
                        valid=torch.ones(m, dtype=torch.bool)),
        labels=[label]))


def reference(st, ctx, got, tf32=False):
    """For each sampled frame, the reference's stages on the program's
    inputs (see the module's docstring); with ``tf32`` (the control's
    call), under ``poses`` besides, the reference's own answers in the
    program's form (``calibrate.control_answers`` puts a serving
    reference's own answers in the program's place from that key)."""
    c = ctx.cell.config
    common.set_precision(c, tf32=tf32)
    try:
        model = build(ctx, "mfbench.reference", ctx.device).eval()
        dev = ctx.device
        out = []
        with torch.no_grad():
            for i, answer in got:
                frame = st.frames[i]
                H, W = frame["rgb"].shape[:2]
                k = n_objects(frame)
                image, hw = model.image(torch.from_numpy(frame["rgb"]).to(dev))
                feats = model.features(image)
                objectness, deltas = model.rpn(feats)
                anchors = model.anchors(feats)
                props = model.proposals(
                    [o.to(dev) for o in answer["objectness"]],
                    [d.to(dev) for d in answer["deltas"]], anchors, hw)
                pboxes = answer["proposals"]["boxes"].to(dev)
                pvalid = answer["proposals"]["valid"].to(dev)
                cls_logits, box_deltas = model.box_outputs(feats, pboxes)
                dets = model.detections(
                    pboxes, pvalid, answer["cls_logits"].to(dev),
                    answer["box_deltas"].to(dev), k, hw)
                dv = answer["detections"]["valid"]
                dboxes = answer["detections"]["boxes"][dv].to(dev)
                dclasses = answer["detections"]["classes"][dv].to(dev)
                logits = model.mask_logits(feats, dboxes, dclasses)
                label = model.paste(logits, dboxes, hw, H, W)
                want = _host(dict(
                    features=feats, objectness=objectness, deltas=deltas,
                    proposals=props, cls_logits=cls_logits,
                    box_deltas=box_deltas, detections=dets,
                    mask_logits=logits, label=label))
                if tf32:
                    want["poses"] = _own_answer(model, feats, hw, k, H, W)
                out.append(want)
    finally:
        common.set_precision(c)
    return out


def _rel(a, b):
    """The largest gap over the reference's largest magnitude."""
    a, b = a.double(), b.double()
    if a.shape != b.shape:
        return float("inf")
    if not b.numel():
        return 0.0
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _selection_gap(got, want):
    """inf unless the kept entries' indices are the reference's, in order;
    else the largest gap of their boxes in pixels."""
    v = got["valid"]
    if not torch.equal(got["index"][v].long(), want["index"].long()):
        return float("inf")
    if not v.any():
        return 0.0
    return float((got["boxes"][v].double()
                  - want["boxes"].double()).abs().max())


def compare(got, want, ctx):
    """``[(name, gap, limit)]`` over the sampled frames (see the module's
    docstring)."""
    lim = ctx.cell.limits
    gaps = dict.fromkeys(lim, 0.0)
    if not got or len(got) != len(want):
        return [(n, float("inf"), lim[n]) for n in lim]
    for (_, answer), ref in zip(got, want):
        if set(answer) == {"poses"}:  # the control: answers in our form
            answer = answer["poses"]
        g = {}
        g["features"] = max(_rel(a, b) for a, b in
                            zip(answer["features"], ref["features"]))
        g["rpn"] = max(_rel(a, b) for a, b in
                       zip(answer["objectness"] + answer["deltas"],
                           ref["objectness"] + ref["deltas"]))
        g["proposals"] = _selection_gap(answer["proposals"],
                                        ref["proposals"])
        pv = answer["proposals"]["valid"]
        g["box"] = float("inf")
        if len(pv) == len(ref["cls_logits"]):
            g["box"] = max(
                _rel(answer["cls_logits"][pv], ref["cls_logits"][pv]),
                _rel(answer["box_deltas"][pv], ref["box_deltas"][pv]))
        g["detections"] = _selection_gap(answer["detections"],
                                         ref["detections"])
        dv = answer["detections"]["valid"]
        g["mask"] = _rel(answer["mask_logits"][dv], ref["mask_logits"])
        g["pixels"] = max(
            float((torch.as_tensor(lab) != ref["label"]).double().mean())
            for lab in answer["labels"])
        for n in gaps:
            gaps[n] = max(gaps[n], g[n])
    return [(n, gaps[n], lim[n]) for n in lim]
