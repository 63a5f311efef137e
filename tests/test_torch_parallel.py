"""The port's data parallelism against the JAX package's, on the CPU.

Two ranks of ``tests/_torch_dp_worker.py`` join a ``gloo`` process group
(a free port, a per-test timeout) while this process runs JAX's
``make_dp_train_step``, ``make_dp_eval_step``, the segmenter's
``shard_map`` step and ``fit`` on a 2-device mesh of the tier's 8 forced
host devices. The draws are the same on both sides: the point sampler of
both models is patched to fixed per-pixel scores, dropout is off (JAX's
model runs with ``train=False``, the port's ``pspnet.dropout`` is the
identity), and JAX's searches are the exact sums (``test_torch_train.py``).

Tolerances, those of ``test_torch_train.py``:
- losses and metrics: rtol 1e-4;
- the gradient averaged over the ranks after the first step (rank 0's
  ``.grad``) against JAX's ``pmean``-ed gradient (read from a recording
  optimizer): each parameter within ``1e-4 |g_jax| + 1e-6 |G_jax|``;
- the parameters after two Adam steps: each entry within a tenth of the
  largest entry of its tensor's JAX update (plus 1e-8). Adam divides each
  gradient entry by its own running magnitude, so where an entry is small
  (the backbone's first convolution sits 1e-5 to 1e-6 below the heads) the
  gradients' 1e-4 rounding reaches the update at a few percent of ``lr``:
  3.9% in the first convolution here. The gradients themselves are held
  tightly above; this rule holds what Adam made of them (the segmenter's
  weights are not held so: its exactly cancelled biases, see there);
- the eval records: rtol 1e-4, atol 1e-6; the AUCs of ``fit``: atol 1e-4.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import morefusion_tpu.parallel as jparallel
from morefusion_tpu import datasets as JD
from morefusion_tpu import models as JM
from morefusion_tpu.models import segmentation as JS
from morefusion_tpu.models import singleview_3d as jsv3d
from morefusion_tpu.training import loop as jloop
from morefusion_tpu.training import trainer as JT
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch import parallel as TP
from morefusion_tpu_torch.parallel import distributed as TPD
from tests import _torch_dp_worker as W
from tests.test_torch_model import _flax_to_np, torch_to_flax
from tests.test_torch_train import _jax_bank, _jax_exact_search

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 240  # seconds for both ranks' whole run
PARAM_ATOL = 0.1  # of the largest update entry; see the docstring


def jax_fixed_sampler(mask, key, n_point):
    """JAX's ``sample_mask_indices`` with the worker's fixed scores."""
    B, H, W_ = mask.shape
    flat = mask.reshape(B, H * W_)
    scores = jnp.asarray(W.fixed_scores(H * W_))[None]
    scores = jnp.where(flat, scores, -jnp.inf)
    _, idx = jax.lax.top_k(scores, n_point)
    n_valid = jnp.maximum(jnp.sum(flat, axis=1), 1)[:, None]
    slot = jnp.arange(n_point)[None, :]
    wrapped = jnp.where(slot < n_valid, slot, slot % n_valid)
    return jnp.take_along_axis(idx, wrapped, axis=1).astype(jnp.int32)


class NoDropout:
    """A JAX SingleView3D whose ``apply`` runs with dropout off."""

    def __init__(self, model):
        self._model = model
        self.voxel_dim = model.voxel_dim

    def init(self, *args, **kw):
        return self._model.init(*args, **kw)

    def apply(self, params, rngs=None, **kw):
        kw["train"] = False
        return self._model.apply(params, **kw)


def recording(tx):
    """``tx`` that also keeps the last gradient it was given in its state."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def mesh2():
    return jparallel.data_mesh(jax.devices()[:2])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The two worker processes, started at once; ``results()`` waits."""

    def __init__(self, root):
        self.root = root
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dp_worker", "--rank",
             str(r), "--world", "2", "--port", str(port), "--dir", root],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        self._results = None

    def results(self):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    out, _ = p.communicate(timeout=WORKER_TIMEOUT)
                    logs.append(out)
            finally:
                for p in self.procs:  # a hung rendezvous fails, not hangs
                    p.kill()
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._results = []
            for r in range(2):
                with open(os.path.join(self.root, f"rank{r}.pkl"), "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    src = TD.SyntheticRGBDPoseEstimationDataset(
        split="train", n_frames=2, n_objects=(2, 3), image_shape=(120, 160))
    TD.reindex(str(root / "reindexed"), [src], n_workers=1, progress=False)
    TD.pack_reindexed(str(root / "reindexed"), str(root / "packed"),
                      progress=False)
    inputs = {f"pose_{k}": v for k, v in W.pose_batch().items()}
    inputs.update({f"seg_{k}": v for k, v in W.seg_batch().items()})
    np.savez(root / "inputs.npz", **inputs)
    jmodel = JS.UNetSegmentation(n_class=22, widths=W.SEG_WIDTHS,
                                 with_boundary=True)
    unet = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 32, 32, 3))))(
        jax.random.PRNGKey(0))
    unet = jax.tree_util.tree_map(np.asarray, unet)
    torch.save(TM.variables_from_jax(unet), root / "unet.pt")
    handle = Ranks(str(root))
    handle.unet = unet
    yield handle
    for p in handle.procs:
        p.kill()


# ------------------------------------------------------------ one process


def test_maybe_initialize_is_a_noop_without_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert TP.maybe_initialize() is False
    assert TP.maybe_initialize(world_size=1) is False
    assert not torch.distributed.is_initialized()
    mesh = TP.data_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.device, mesh.distributed) == (
        1, 0, torch.device("cpu"), False)
    assert TP.is_primary()
    TP.barrier()
    assert TP.broadcast_obj({"a": 1}) == {"a": 1}
    assert TP.gather_obj(3) == [3]
    assert TPD.local_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert TPD.local_device("cuda") == torch.device("cuda", 3)
    assert TPD.local_device("cpu") == torch.device("cpu")


def test_oversized_object_raises_as_in_jax():
    from morefusion_tpu.parallel import distributed as jdist

    for pkg in (jdist, TPD):
        with pytest.raises(ValueError, match="object too large"):
            pkg._obj_to_array(b"x" * 2000, 1024)
        buf = pkg._obj_to_array({"k": [1, 2]}, 256)
        assert pkg._array_to_obj(buf) == {"k": [1, 2]}
    np.testing.assert_array_equal(jdist._obj_to_array(("a", 1), 64),
                                  TPD._obj_to_array(("a", 1), 64))


@pytest.mark.parametrize("B,world", [(16, 1), (16, 2), (16, 4), (10, 4),
                                     (48, 3)])
def test_local_batch_slice_matches_jax(B, world):
    for rank in range(world):
        with mock.patch.object(jax, "process_count", lambda: world), \
                mock.patch.object(jax, "process_index", lambda: rank):
            want = jparallel.local_batch_slice(B)
        mesh = TP.DataMesh(world, rank, torch.device("cpu"))
        assert TP.local_batch_slice(B, mesh) == want


def test_shard_and_replicate_in_one_process():
    mesh = TP.data_mesh("cpu")
    batch = {"a": np.arange(6).reshape(3, 2), "b": torch.ones(3)}
    out = TP.shard_batch(batch, mesh)
    np.testing.assert_array_equal(out["a"].numpy(), batch["a"])
    assert torch.equal(out["b"], batch["b"])
    t = torch.arange(3.0)
    assert TP.replicate(t, mesh) is t and torch.equal(t, torch.arange(3.0))


# -------------------------------------------------------------- two ranks


def _jax_seg_step(jmodel, mesh):
    """The shard_map step of ``examples/train_segmentation.py``."""
    from jax.sharding import PartitionSpec as P

    def train_step(state, batch):
        def loss_fn(p):
            logits, blog = jmodel.apply(p, batch["rgb"].astype(jnp.float32))
            l_cls = JS.segmentation_loss(
                logits, batch["class_label"].astype(jnp.int32),
                fg_weight=W.FG_WEIGHT)
            return l_cls + JS.boundary_loss(blog, batch["boundary"])

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        grads = jax.lax.pmean(grads, "data")
        loss = jax.lax.pmean(loss, "data")
        return state.apply_gradients(grads=grads), loss

    return jax.jit(jax.shard_map(
        train_step, mesh=mesh, in_specs=(P(), P("data")),
        out_specs=(P(), P()), check_vma=False))


def test_segmenter_ddp_step_matches_jax_shard_map(ranks):
    batch = W.seg_batch()
    model = W.tiny_unet(ranks.root)
    jmodel = JS.UNetSegmentation(n_class=22, widths=W.SEG_WIDTHS,
                                 with_boundary=True)
    params = ranks.unet
    mesh = mesh2()
    state = JT.TrainState.create(apply_fn=jmodel.apply, params=params,
                                 tx=recording(optax.adam(1e-3)))
    step = _jax_seg_step(jmodel, mesh)
    sb = jparallel.shard_batch(batch, mesh)
    losses, grads = [], None
    for _ in range(2):
        state, loss = step(state, sb)
        losses.append(float(loss))
        if grads is None:
            grads = state.opt_state[1]
    r0, r1 = ranks.results()
    np.testing.assert_allclose(r0["seg"]["losses"], losses, rtol=1e-5)
    assert r0["seg"]["losses"] == r1["seg"]["losses"]

    # the two shards' foreground differs, so the mean of the shards'
    # weighted means (JAX's pmean, the port's DDP) is not the global
    # weighted mean; the port computes the former
    def loss_of(b):
        logits, blog = jmodel.apply(params, jnp.asarray(b["rgb"], jnp.float32))
        return float(JS.segmentation_loss(
            logits, jnp.asarray(b["class_label"], jnp.int32),
            fg_weight=W.FG_WEIGHT) + JS.boundary_loss(blog, b["boundary"]))

    halves = [loss_of({k: v[s] for k, v in batch.items()})
              for s in (slice(0, 2), slice(2, 4))]
    global_mean = loss_of(batch)
    np.testing.assert_allclose(r0["seg"]["losses"][0], np.mean(halves),
                               rtol=1e-5)
    assert abs(global_mean - np.mean(halves)) > 100 * 1e-5 * abs(global_mean)

    # the gradient of the first step, averaged over the ranks; no weights
    # after Adam: a conv bias under a one-channel GroupNorm has an exactly
    # cancelled gradient, whose sign Adam's first update takes at lr
    want = TM.variables_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    _hold_gradients(r0["seg"]["grads"], want)


@pytest.fixture(scope="module")
def jax_dp(ranks):
    """JAX's ``make_dp_train_step`` and ``make_dp_eval_step`` on a 2-device
    mesh, from the port's initial weights, two steps."""
    model = W.tiny_model()
    jbank = _jax_bank(W.small_bank())
    jmodel = NoDropout(JM.tiny_singleview3d(21, n_point=32,
                                            with_occupancy=True))
    mesh = mesh2()
    batch = W.pose_batch()
    state = JT.TrainState.create(apply_fn=jmodel.apply,
                                 params=torch_to_flax(model),
                                 tx=recording(optax.adam(1e-4)))
    with mock.patch.object(jsv3d, "sample_mask_indices", jax_fixed_sampler), \
            _jax_exact_search():
        step = JT.make_dp_train_step(jmodel, jbank, mesh,
                                     with_occupancy=True,
                                     occupancy_loss_term=True)
        sb = jparallel.shard_batch(batch, mesh)
        metrics, grads = [], None
        for k in range(2):
            state, m = step(state, sb, np.bool_(True), jax.random.PRNGKey(0))
            metrics.append({k2: float(v) for k2, v in m.items()})
            if k == 0:
                grads = TM.params_from_jax(_flax_to_np(state.opt_state[1]))
        eval_step = JT.make_dp_eval_step(jmodel, jbank, mesh,
                                         with_occupancy=True)
        records = jax.device_get(eval_step(state.params, sb))
    return dict(metrics=metrics, grads=grads, records=records,
                params=TM.params_from_jax(_flax_to_np(state.params)),
                start={k: v.detach().numpy() for k, v in
                       model.named_parameters()})


def _hold_gradients(got, want):
    """``test_torch_train.py``'s rule: each parameter's gradient within
    ``1e-4 |g_jax| + 1e-6 |G_jax|``."""
    assert sorted(got) == sorted(want)
    total = float(torch.cat([g.reshape(-1) for g in want.values()]).norm())
    for name, g in got.items():
        err = float(np.linalg.norm(g - want[name].numpy()))
        assert err <= 1e-4 * float(want[name].norm()) + 1e-6 * total, name


def test_dp_train_step_matches_jax_on_two_devices(ranks, jax_dp):
    r0 = ranks.results()[0]["dp"]
    for got, want in zip(r0["metrics"], jax_dp["metrics"]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
    _hold_gradients(r0["grads"], jax_dp["grads"])
    for name, p in r0["params"].items():
        w = jax_dp["params"][name].numpy()
        update = np.abs(w - jax_dp["start"][name]).max()
        np.testing.assert_allclose(p, w, rtol=0,
                                   atol=PARAM_ATOL * update + 1e-8, err_msg=name)


def test_dp_eval_step_matches_jax(ranks, jax_dp):
    r0, r1 = ranks.results()
    want = jax_dp["records"]
    for k in want:
        got = np.concatenate([r0["dp"]["eval"][k], r1["dp"]["eval"][k]])
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_fit_at_world_size_two_matches_jax(ranks, tmp_path):
    r0, r1 = ranks.results()
    root = ranks.root
    assert r0["fit"]["step"] == r1["fit"]["step"] == 2
    assert r1["fit"]["summary"] == {}
    assert not os.path.exists(os.path.join(root, "fit_rank1"))
    out0 = os.path.join(root, "fit_rank0")
    for name in ("args.json", "log.json", "timing.json",
                 "snapshot_trainer_latest",
                 "snapshot_model_best_validation_main_auc.npz"):
        assert os.path.exists(os.path.join(out0, name)), name

    model = W.tiny_model(with_occupancy=False)
    jmodel = NoDropout(JM.tiny_singleview3d(21, n_point=32))

    def create(m, example, rng, learning_rate, with_occupancy=False):
        return JT.TrainState.create(apply_fn=jmodel.apply,
                                    params=torch_to_flax(model),
                                    tx=optax.adam(learning_rate))

    one = jparallel.data_mesh
    data = os.path.join(root, "packed")
    out = str(tmp_path / "jax")
    with mock.patch.object(jsv3d, "sample_mask_indices", jax_fixed_sampler), \
            _jax_exact_search(), \
            mock.patch.object(jloop, "create_train_state", create), \
            mock.patch.object(jparallel, "data_mesh",
                              lambda: one(jax.devices()[:2])):
        state, summary = jloop.fit(
            model=jmodel, models_bank=JD.ProceduralModels(),
            train_dataset=JD.PackedPoseDataset(data),
            val_dataset=JD.PackedPoseDataset(data, split="val"),
            out_dir=out, transform_train=JD.Transform(True, False),
            transform_val=JD.Transform(False, False), n_fg_class=21,
            batch_size=4, epochs=2, eval_interval=1.0, log_interval=1,
            val_batch_size=4)
    with open(os.path.join(out0, "log.json")) as f:
        got = json.load(f)
    with open(os.path.join(out, "log.json")) as f:
        want = json.load(f)
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want]
    for g, w in zip(got, want):
        for k in w:
            if k.startswith("main/loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            elif "auc" in k:
                np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=k)
    assert sorted(summary) == sorted(r0["fit"]["summary"])
    want_p = TM.params_from_jax(_flax_to_np(state.params))
    start = {k: v.detach().numpy() for k, v in model.named_parameters()}
    for name, p in r0["fit"]["params"].items():
        w = want_p[name].numpy()
        update = np.abs(w - start[name]).max()
        np.testing.assert_allclose(p, w, rtol=0, atol=PARAM_ATOL * update + 1e-8,
                                   err_msg=name)


def test_collectives_across_two_ranks(ranks):
    r0, r1 = ranks.results()
    assert r0["mesh"] == (2, 0, "cpu") and r1["mesh"] == (2, 1, "cpu")
    c0, c1 = r0["collectives"], r1["collectives"]
    assert c0["is_primary"] and not c1["is_primary"]
    assert c0["broadcast"] == c1["broadcast"] == {"from": 0}
    assert c0["gather"] == [("rank", 0), ("rank", 1)]
    assert c1["gather"] is None
    for c in (c0, c1):
        assert "object too large" in c["too_large"]
        np.testing.assert_array_equal(c["replicated"][0], [1.0, 1.0, 1.0])
        np.testing.assert_array_equal(c["replicated"][1], np.zeros((2, 2)))
    assert c0["slice"] == slice(0, 8) and c1["slice"] == slice(8, 16)
    np.testing.assert_array_equal(c0["shard"], [0, 1, 2, 3])
    np.testing.assert_array_equal(c1["shard"], [4, 5, 6, 7])


def test_ranks_draw_distinct_streams_and_end_equal(ranks):
    r0, r1 = ranks.results()
    for a, b in zip(r0["dp"]["draws"], r1["dp"]["draws"]):
        assert not np.array_equal(a, b)
    # rank 0 draws what one process draws
    from morefusion_tpu_torch.training import trainer as TT

    for a, g in zip(r0["dp"]["draws"], TT.step_generators(0, 0, "cpu")):
        np.testing.assert_array_equal(a, torch.rand(4, generator=g).numpy())
    for name, p in r0["dp"]["params"].items():
        np.testing.assert_array_equal(p, r1["dp"]["params"][name], name)
    assert r0["dp"]["metrics"] == r1["dp"]["metrics"]


def test_every_parameter_gets_a_gradient_under_ddp(ranks):
    for r in ranks.results():
        assert r["dp"]["find_unused"] is False
        assert all(g is not None for g in r["dp"]["grads"].values())


def test_posenet_and_unet_leave_no_parameter_unused():
    """DDP runs with ``find_unused_parameters=False``: every parameter of
    the other models the DP steps train gets a gradient in one step."""
    from morefusion_tpu_torch.cli import train_segmentation as seg_cli
    from morefusion_tpu_torch.training import trainer as TT

    batch = {k: v[:2] for k, v in W.pose_batch().items()
             if not k.startswith("grid")}
    torch.manual_seed(0)
    posenet = TM.PoseNet(n_fg_class=21, n_point=32)
    TT.make_train_step(posenet, W.small_bank())(
        TT.create_train_state(posenet), batch, True)
    torch.manual_seed(0)
    unet = TM.UNetSegmentation(n_class=22, widths=W.SEG_WIDTHS,
                               with_boundary=True)
    seg_cli.make_train_step(TT.create_train_state(unet, 1e-3))(
        {k: v[:2] for k, v in W.seg_batch().items()})
    for model in (posenet, unet):
        assert not list(model.buffers())
        assert all(p.grad is not None for p in model.parameters())
