"""The port's segmenter training against ``morefusion_tpu`` on the CPU.

- ``segmentation_loss`` (ignore-label pixels, ``fg_weight`` 1 and 3) and
  ``boundary_loss``: values and gradients within 1e-6 relative (float32
  inputs on both sides; the port's logits are NCHW, JAX's NHWC);
- ``BackgroundComposite``: the procedural backgrounds bit for bit for 3
  seeds x the 4 kinds, and the composite of a frame;
- ``SyntheticInstanceSegmentationDataset``: examples identical in all three
  formats, with and without compositing, and through the
  ``MFTPU_SEG_CACHE`` disk cache (either package reading the other's);
- one UNet train step (widths (8, 16), both heads, with and without
  depth) from JAX's init carried over by ``variables_from_jax``, on the
  quantised batch the script ships: the loss within 1e-6 relative, the
  gradients by ``test_torch_train.py``'s rule, and each parameter's Adam
  update that of ``optax.adam`` on those gradients within rtol 1e-6, atol
  1e-9 (as ``test_torch_fit.py`` holds Adam);
- ``cli.train_segmentation --device cpu`` beside
  ``examples/train_segmentation.py`` through ``runpy`` (4 frames, 2 steps,
  small frames; JAX's data mesh cut to one device, since the CPU tier has
  eight): the same files and keys; with ``--eval-only`` on the same
  parameters (JAX's restore patched to them), the same held-out mIoU,
  detection rate, precision, ``n_gt`` and per-class table, also with
  ``--no-merge --min-area 30``; and ``--eval-only`` restores the port's
  latest checkpoint.
"""

import json
import os
import runpy
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import morefusion_tpu.parallel as jparallel
import morefusion_tpu.training as jtraining
from morefusion_tpu.datasets import background_composite as jbg
from morefusion_tpu.datasets import instance_segmentation as jis
from morefusion_tpu.models import segmentation as JS
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch import training as TT
from morefusion_tpu_torch.cli import train_segmentation as cli
from morefusion_tpu_torch.datasets import background_composite as tbg
from morefusion_tpu_torch.datasets import instance_segmentation as tis
from morefusion_tpu_torch.models import segmentation as TS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "train_segmentation.py")
SHAPE = (48, 64)
WIDTHS = (8, 16)


def _equal(a, b, key=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, key
    np.testing.assert_array_equal(a, b, err_msg=str(key))


# ------------------------------------------------------------------ losses


def _labels(rng, B=2, H=6, W=8, C=5):
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.2] = -1
    return labels


@pytest.mark.parametrize("fg_weight", [1.0, 3.0])
def test_segmentation_loss_matches_jax(rng, fg_weight):
    logits = rng.normal(0, 2, (2, 6, 8, 5)).astype(np.float32)
    labels = _labels(rng)
    assert (labels == -1).any() and (labels == 0).any()
    jv, jg = jax.value_and_grad(
        lambda x: JS.segmentation_loss(x, labels, fg_weight=fg_weight))(
        logits)
    t = torch.tensor(logits.transpose(0, 3, 1, 2), requires_grad=True)
    loss = TS.segmentation_loss(t, torch.from_numpy(labels),
                                fg_weight=fg_weight)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jg), rtol=1e-6, atol=1e-9)


def test_segmentation_loss_all_ignored_is_zero():
    logits = torch.zeros(1, 3, 2, 2, requires_grad=True)
    labels = torch.full((1, 2, 2), -1)
    loss = TS.segmentation_loss(logits, labels)
    loss.backward()
    assert float(loss.detach()) == 0.0 and torch.all(logits.grad == 0)


@pytest.mark.parametrize("pos_weight", [5.0, 1.0])
def test_boundary_loss_matches_jax(rng, pos_weight):
    logits = rng.normal(0, 3, (2, 6, 8)).astype(np.float32)
    truth = rng.rand(2, 6, 8) < 0.1
    jv, jg = jax.value_and_grad(
        lambda x: JS.boundary_loss(x, truth, pos_weight=pos_weight))(logits)
    t = torch.tensor(logits, requires_grad=True)
    loss = TS.boundary_loss(t, torch.from_numpy(truth.astype(np.uint8)),
                            pos_weight=pos_weight)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)


# ------------------------------------------------------------- backgrounds


class _ForcedKind(np.random.RandomState):
    """A RandomState whose first ``randint(4)`` (the background's kind) is
    ``kind``; every later draw is the seed's own."""

    def __init__(self, seed, kind):
        super().__init__(seed)
        self._kind = kind

    def randint(self, *args, **kw):
        if self._kind is not None and args == (4,) and not kw:
            kind, self._kind = self._kind, None
            return kind
        return super().randint(*args, **kw)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_procedural_background_matches_jax(seed, kind):
    got = tbg._procedural_background((40, 56), _ForcedKind(seed, kind))
    want = jbg._procedural_background((40, 56), _ForcedKind(seed, kind))
    assert got.dtype == np.uint8 and got.shape == (40, 56, 3)
    _equal(got, want)


def test_background_composite_matches_jax(rng):
    rgb = rng.randint(0, 255, (40, 56, 3)).astype(np.uint8)
    label = np.full((40, 56), -1, np.int32)
    label[10:30, 5:40] = 0
    tc, jc = tbg.BackgroundComposite(seed=7), jbg.BackgroundComposite(seed=7)
    for _ in range(8):
        got = tc(rgb, label)
        _equal(got, jc(rgb, label))
        _equal(got[label >= 0], rgb[label >= 0])


# ----------------------------------------------------------------- dataset


def _check_examples(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, i)
        return
    assert sorted(got) == sorted(want)
    for k in want:
        _equal(got[k], want[k], k)


def _datasets(**kw):
    kw = dict(n_frames=2, image_shape=SHAPE, n_objects=(2, 3), seed=5, **kw)
    return (tis.SyntheticInstanceSegmentationDataset(**kw),
            jis.SyntheticInstanceSegmentationDataset(**kw))


@pytest.mark.parametrize("composite", [True, False])
@pytest.mark.parametrize("format", ["class_label", "masks", "instance"])
def test_instance_segmentation_examples_match_jax(format, composite):
    tds, jds = _datasets(format=format, background_composite=composite)
    for i in (1, 0, 1):  # the second call of 1 comes from the frame cache
        _check_examples(tds.get_example(i), jds.get_example(i))


def test_instance_segmentation_disk_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MFTPU_SEG_CACHE", str(tmp_path / "jax_first"))
    tds, jds = _datasets(format="instance")
    want = jds.get_example(0)  # JAX writes the frame
    _check_examples(tds.get_example(0), want)  # the port reads it
    monkeypatch.setenv("MFTPU_SEG_CACHE", str(tmp_path / "port_first"))
    tds, jds = _datasets(format="instance", cache=False)
    got = tds.get_example(1)  # the port writes the frame
    files = os.listdir(os.path.join(tmp_path, "port_first",
                                    "train_s5_48x64_o2-3"))
    assert files == ["000001.npz"]
    _check_examples(got, jds.get_example(1))  # JAX reads it
    # both read it again (cache=False), with their second backgrounds
    _check_examples(tds.get_example(1), jds.get_example(1))


def test_frame_to_class_label_and_masks_match_jax(rng):
    label = rng.randint(-1, 3, (12, 16)).astype(np.int32)
    frame = dict(instance_label=label, instance_ids=np.array([0, 1, 2, 5]),
                 class_ids=np.array([4, 9, 4, 2]),
                 rgb=rng.randint(0, 255, (12, 16, 3)).astype(np.uint8))
    _equal(tis.frame_to_class_label(frame), jis.frame_to_class_label(frame))
    _check_examples(tis.frame_to_masks(frame), jis.frame_to_masks(frame))


# --------------------------------------------------------------- the step


def _small_batch(rng, use_depth, B=2):
    ex = dict(
        rgb=rng.uniform(0, 255, (B,) + SHAPE + (3,)).astype(np.float32),
        class_label=rng.randint(0, 22, (B,) + SHAPE).astype(np.int32),
        boundary=rng.rand(B, *SHAPE) < 0.05,
        depth=rng.uniform(0.4, 1.2, (B,) + SHAPE).astype(np.float32),
    )
    return cli.quantize_batch(ex, use_depth)


@pytest.mark.parametrize("use_depth,fg_weight", [(False, 1.0), (True, 3.0)])
def test_unet_train_step_matches_jax(rng, use_depth, fg_weight):
    small = _small_batch(rng, use_depth)
    assert small["rgb"].dtype == np.uint8
    assert small["class_label"].dtype == np.int8
    jmodel = JS.UNetSegmentation(n_class=22, widths=WIDTHS,
                                 with_boundary=True, use_depth=use_depth)

    def inputs(b):
        kw = {}
        if use_depth:
            kw["depth"] = b["depth"].astype(jnp.float32)
        return (b["rgb"].astype(jnp.float32),), kw

    args, kw = inputs(small)
    params = jax.jit(lambda k: jmodel.init(k, *args, **kw))(
        jax.random.PRNGKey(0))

    def loss_fn(p):  # the script's loss_fn
        logits, blog = jmodel.apply(p, *args, **kw)
        l_cls = JS.segmentation_loss(
            logits, small["class_label"].astype(jnp.int32),
            fg_weight=fg_weight)
        return l_cls + JS.boundary_loss(blog, small["boundary"])

    jv, jg = jax.jit(jax.value_and_grad(loss_fn))(params)

    model = TS.UNetSegmentation(n_class=22, widths=WIDTHS,
                                with_boundary=True, use_depth=use_depth)
    model.load_state_dict(TM.variables_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TT.create_train_state(model, 1e-3)
    loss = cli.make_train_step(state, fg_weight=fg_weight)(small)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-6)

    # the gradients, by test_torch_train.py's rule
    want = TM.variables_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    total = float(torch.cat([g.reshape(-1) for g in want.values()]).norm())
    for name, g in got.items():
        err = float((g - want[name]).norm())
        assert err <= 1e-4 * float(want[name].norm()) + 1e-6 * total, name
    # the update: optax's Adam on the port's gradients (its first update is
    # about lr * sign(g), so it would amplify the gradients' rounding where
    # |g| nears Adam's eps: a conv bias under a one-channel GroupNorm has
    # an exactly cancelled gradient)
    grads = {k: g.numpy() for k, g in got.items()}
    start = {k: v.numpy() for k, v in before.items()}
    tx = optax.adam(1e-3)
    updates, _ = tx.update(grads, tx.init(start), start)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(start[name] + updates[name]),
            rtol=1e-6, atol=1e-9, err_msg=name)


# ------------------------------------------------------------------ the CLI

FLAGS = ["--n-frames", "4", "--n-val-frames", "2", "--image-shape",
         str(SHAPE[0]), str(SHAPE[1]), "--n-objects", "2", "3",
         "--batch-size", "2", "--steps", "2", "--widths", "8", "16",
         "--seed", "3"]


def _run_jax_script(argv):
    one = jparallel.data_mesh
    with mock.patch.object(sys, "argv", ["train_segmentation.py"] + argv), \
            mock.patch.object(jparallel, "data_mesh",
                              lambda: one(jax.devices()[:1])):
        runpy.run_path(SCRIPT, run_name="__main__")


def _read(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts trained on the same frames (through one disk cache)."""
    root = tmp_path_factory.mktemp("seg_runs")
    with mock.patch.dict(os.environ,
                         {"MFTPU_SEG_CACHE": str(root / "cache")}):
        _run_jax_script(["--out", str(root / "jax")] + FLAGS)
        state, summary = cli.main(["--out", str(root / "port"),
                                   "--device", "cpu"] + FLAGS)
    return root, state, summary


def test_train_segmentation_cli_writes_jax_files(runs):
    root, state, summary = runs
    jax_out, port_out = str(root / "jax"), str(root / "port")
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    assert state.step == 2
    for name in ("args.json", "per_class.json"):
        got, want = _read(port_out, name), _read(jax_out, name)
        if name == "args.json":
            assert sorted(got) == sorted(list(want) + ["device"])
            assert got["device"] == "cpu"
        else:  # the predicted classes differ between the two models
            assert sorted(got["_summary"]) == sorted(want["_summary"])
            assert ({k for k, v in got.items() if v.get("n_gt")}
                    == {k for k, v in want.items() if v.get("n_gt")})
            assert {tuple(sorted(v)) for v in got.values()} == {
                tuple(sorted(v)) for v in want.values()}
    got, want = _read(port_out, "log.json"), _read(jax_out, "log.json")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert got[-1]["iteration"] == want[-1]["iteration"] == 2
    assert summary["validation/miou"] == got[-1]["validation/miou"]


@pytest.mark.parametrize("extra", [[], ["--no-merge", "--min-area", "30"]])
def test_eval_only_matches_jax_on_the_same_parameters(runs, tmp_path,
                                                      extra):
    root, state, _ = runs
    # the port's trained parameters, given to both scripts
    variables = {"params": {}}
    for key, arr in TM.params_to_jax(state.model.state_dict()).items():
        node = variables
        path = key[2:-2].split("']['")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jax_out)
    TT.CheckpointManager(port_out).save_latest(state, 2)

    with mock.patch.dict(os.environ,
                         {"MFTPU_SEG_CACHE": str(root / "cache")}), \
            mock.patch.object(jtraining.CheckpointManager, "restore_latest",
                              lambda self, s: s.replace(params=variables)):
        _run_jax_script(["--out", jax_out, "--eval-only"] + FLAGS + extra)
        cli.main(["--out", port_out, "--device", "cpu", "--eval-only"]
                 + FLAGS + extra)
    name = cli.per_class_name(cli.parse_args(["--out", "x"] + extra))
    assert name == ("per_class.json" if not extra
                    else "per_class_nomerge_a30.json")
    want = _read(jax_out, name)
    assert want["_summary"]["n_gt"] > 0
    assert _read(port_out, name) == want
    got_row, want_row = (_read(port_out, "log.json")[-1],
                         _read(jax_out, "log.json")[-1])
    for k in ("validation/miou", "validation/detection_rate",
              "validation/precision", "validation/n_gt"):
        assert got_row[k] == want_row[k], k


def test_eval_only_restores_the_latest_checkpoint(runs, tmp_path):
    root, state, summary = runs
    with mock.patch.dict(os.environ,
                         {"MFTPU_SEG_CACHE": str(root / "cache")}):
        restored, again = cli.main(["--out", str(root / "port"), "--device",
                                    "cpu", "--eval-only"] + FLAGS)
        with pytest.raises(SystemExit, match="no checkpoint"):
            cli.main(["--out", str(tmp_path), "--device", "cpu",
                      "--eval-only"] + FLAGS)
    assert restored.step == 2 and again == summary
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
