"""The port's backbone pretraining against ``examples/pretrain_backbone.py``.

On the CPU at width 8:
- the RotNet step (bf16 compute, as JAX's) from JAX's init: the port's
  loss no farther from JAX's bf16 loss than JAX's bf16 is from its fp32
  (the bf16 gap of ``test_torch_bf16.py``), the same for the accuracy, and
  the update of every parameter within the gap of the fp32 and bf16 JAX
  updates (Adam's first step moves each weight by about the learning rate,
  so it is the gradients' signs that are held);
- the schedule against optax's ``warmup_cosine_decay_schedule(0, lr, w,
  d)`` at every step of a run, for a few ``--steps`` / ``--warmup-steps``;
- the held-out split, the crops and the rotations of every batch, train
  and val, equal to the JAX script's draws (both scripts run through
  ``runpy`` / ``main`` with ``np.rot90`` recorded);
- ``backbone_bf16.npz`` entry for entry (keys, order, bytes) equal to JAX's
  export of the same parameters, and ``cli.train --pretrained-backbone``
  grafting it into SingleView3D (``--tiny``, width 8) and PoseNet (full
  width, width-64 export) at ``--max-steps 0``.
"""

import json
import os
import runpy
import sys
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morefusion_tpu.models.resnet import DilatedResNet18 as JResNet18
from morefusion_tpu.training import checkpoints as JC
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.cli import pretrain_backbone as cli
from morefusion_tpu_torch.cli import train as train_cli
from morefusion_tpu_torch.training import checkpoints as TC
from morefusion_tpu_torch.training.trainer import create_train_state

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "pretrain_backbone.py")
WIDTH = 8
S = 32  # crop side


class JRotNet(nn.Module):
    """The JAX script's ``RotNet`` (defined inside its ``main``)."""

    base_width: int = 64
    dtype: object = jnp.bfloat16

    def setup(self):
        self.resnet_extractor = JResNet18(base_width=self.base_width,
                                          dtype=self.dtype)
        self.rot_head = nn.Dense(4)

    def __call__(self, rgb):
        h = self.resnet_extractor(rgb)
        h = jnp.mean(h.astype(jnp.float32), axis=(1, 2))
        return self.rot_head(h)


def _crops(rng, n):
    return rng.randint(0, 256, (n, S, S, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_params():
    rgb = _crops(np.random.RandomState(1), 2)
    params = jax.jit(JRotNet(WIDTH).init)(jax.random.PRNGKey(0), rgb)
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params, width=WIDTH):
    model = cli.RotNet(base_width=width)
    model.load_state_dict(TM.variables_from_jax(params), strict=True)
    return model


def test_rotnet_step_within_jax_bf16_gap(rng, jax_params):
    rgb = _crops(rng, 16)
    label = rng.randint(0, 4, 16)
    lr = 3e-4

    def jax_step(dtype):
        model = JRotNet(WIDTH, dtype)

        def loss_fn(p):
            logits = model.apply(p, rgb)
            ll = optax.softmax_cross_entropy_with_integer_labels(
                logits, label)
            return jnp.mean(ll), jnp.mean(jnp.argmax(logits, -1) == label)

        (loss, acc), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax_params)
        tx = optax.adam(lr)
        updates, _ = tx.update(g, tx.init(jax_params), jax_params)
        new = optax.apply_updates(jax_params, updates)
        return float(loss), float(acc), TM.variables_from_jax(
            jax.tree_util.tree_map(np.asarray, new))

    l16, a16, p16 = jax_step(jnp.bfloat16)
    l32, a32, p32 = jax_step(jnp.float32)

    model = _port(jax_params)
    assert model.resnet_extractor.compute_dtype == torch.bfloat16
    state = create_train_state(model, lr)
    state.optimizer.zero_grad()
    loss, acc = cli.rotnet_loss(model, torch.from_numpy(rgb),
                                torch.from_numpy(label))
    loss.backward()
    state.optimizer.step()
    loss_gap, loss_err = abs(l16 - l32), abs(float(loss.detach()) - l16)
    assert loss_gap > 0, "JAX's bf16 did not compute in bf16"
    assert loss_err <= loss_gap, (loss_err, loss_gap)
    assert abs(float(acc) - a16) <= abs(a16 - a32)

    def flat(sd):
        return torch.cat([sd[k].reshape(-1) for k in sorted(sd)])

    got = {k: v.detach() for k, v in model.state_dict().items()}
    upd_gap = float((flat(p16) - flat(p32)).norm())
    upd_err = float((flat(got) - flat(p16)).norm())
    assert upd_err <= upd_gap, (upd_err, upd_gap)


@pytest.mark.parametrize("steps,warmup", [(30, 100), (400, 100), (5, 0),
                                          (1, 1)])
def test_schedule_matches_optax_at_every_step(steps, warmup):
    args = cli.parse_args(["--out", "x", "--data", "d", "--steps",
                           str(steps), "--warmup-steps", str(warmup),
                           "--lr", "3e-4"])
    w = min(warmup, max(steps // 10, 1))
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, w,
                                              max(steps, w + 1))
    got = cli.learning_rate(args)
    for count in range(steps + 2):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=count)


@pytest.fixture(scope="module")
def packed_dirs(tmp_path_factory):
    """Two stores holding only the ``rgb.npy`` the scripts read."""
    root = tmp_path_factory.mktemp("pretrain_data")
    rng = np.random.RandomState(3)
    dirs = []
    for i, n in enumerate((13, 9)):
        d = root / f"set{i}"
        d.mkdir()
        np.save(d / "rgb.npy", _crops(rng, n))
        dirs.append(str(d))
    return dirs


def _recorded(run):
    """The ``(k, crop bytes)`` of every ``np.rot90`` call of ``run``."""
    calls = []
    real = np.rot90

    def rot90(im, k=1, axes=(0, 1)):
        calls.append((int(k), np.asarray(im).tobytes()))
        return real(im, k, axes)

    with mock.patch.object(np, "rot90", rot90):
        run()
    return calls


def test_batches_match_the_jax_script(tmp_path, packed_dirs):
    flags = ["--data", *packed_dirs, "--steps", "3", "--batch-size", "4",
             "--n-val", "8", "--eval-interval", "2", "--width", str(WIDTH),
             "--seed", "5"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")

    def run_jax():
        with mock.patch.object(sys, "argv", ["pretrain_backbone.py",
                                             "--out", jax_out] + flags):
            runpy.run_path(SCRIPT, run_name="__main__")

    want = _recorded(run_jax)
    got = _recorded(lambda: cli.main(["--out", port_out, "--device", "cpu"]
                                     + flags))
    # 3 train batches of 4, two evaluations of 8 held-out crops
    assert len(want) == 3 * 4 + 2 * 8
    assert got == want
    crops = cli.Crops(packed_dirs, 8, 5)
    assert len(crops.train_idx) == 22 - 8
    for name in ("log.jsonl", "args.json", "backbone_bf16.npz"):
        assert os.path.isfile(os.path.join(port_out, name)), name
    with open(os.path.join(port_out, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(jax_out, "log.jsonl")) as f:
        want_rows = [json.loads(line) for line in f]
    assert [sorted(r) for r in rows] == [sorted(r) for r in want_rows]
    assert [r["step"] for r in rows] == [2, 3]


def _entries(path):
    with np.load(path) as data:
        return [(k, data[k].dtype, data[k].tobytes()) for k in data.files]


def test_backbone_export_equals_jax(tmp_path, jax_params):
    want = str(tmp_path / "jax.npz")
    JC.export_params_npz(
        {"resnet_extractor": jax_params["params"]["resnet_extractor"]}, want)
    got = str(tmp_path / "port.npz")
    TC.export_backbone_npz(_port(jax_params), got)
    assert _entries(got) == _entries(want)
    assert all(k.startswith("bf16:['resnet_extractor']")
               for k, _, _ in _entries(got))


@pytest.fixture(scope="module")
def reindexed(tmp_path_factory):
    root = tmp_path_factory.mktemp("graft_data")
    src = TD.SyntheticRGBDPoseEstimationDataset(
        split="train", n_frames=1, n_objects=(2, 2), image_shape=(96, 128))
    TD.reindex(str(root), [src], n_workers=1, progress=False)
    return str(root)


@pytest.mark.parametrize("model", ["singleview_3d", "posenet"])
def test_train_cli_grafts_the_export(tmp_path, reindexed, model):
    width = WIDTH if model == "singleview_3d" else 64
    torch.manual_seed(7)
    donor = cli.RotNet(base_width=width)
    path = str(tmp_path / "backbone_bf16.npz")
    TC.export_backbone_npz(donor, path)
    state, _ = train_cli.main([
        "--out", str(tmp_path / "run"), "--data", reindexed, "--model",
        model, "--tiny", "--device", "cpu", "--max-steps", "0",
        "--pretrained-backbone", path, "--min-visibility", "0"])
    want = donor.resnet_extractor.state_dict()
    got = state.model.resnet_extractor.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(torch.bfloat16).to(torch.float32)), k
