"""The port's training loop and what it calls, against ``morefusion_tpu``.

On the CPU at a small size: the learning rate (constant and
``examples/train.py``'s warmup-cosine) against optax at every step of a
30-step schedule, and Adam with the schedule against ``optax.adam`` after
three updates (rtol 1e-6, atol 1e-9, as ``test_torch_train.py`` holds
Adam); the loss without the occupancy term; the evaluator's summaries and
``LogReport``'s rows equal to JAX's; the npz archive equal to JAX's entry
for entry (the same keys in the same order, the same bytes; the zip
container's time stamps differ) in both directions, with a forward of the
JAX model on the port's archive within 1e-5 of the port's; the committed
occupancy checkpoint through import and export unchanged; the latest
snapshot round-trips the model, the optimizer, the schedule and the step;
``fit`` on a packed set of the port's generator (tiny model, B = 2, two
epochs with evaluation, then a resume) and the train CLI.
"""

import argparse
import json
import os
from unittest import mock

import jax
import numpy as np
import optax
import pytest
import torch

from morefusion_tpu import models as JM
from morefusion_tpu.training import checkpoints as JC
from morefusion_tpu.training import evaluator as JE
from morefusion_tpu.training import reporting as JR
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.cli import train as cli
from morefusion_tpu_torch.training import checkpoints as TC
from morefusion_tpu_torch.training import evaluator as TE
from morefusion_tpu_torch.training import loop as TLoop
from morefusion_tpu_torch.training import reporting as TR
from morefusion_tpu_torch.training import trainer as TT
from tests.test_torch_bf16 import carried
from tests.test_torch_model import _inputs
from tests.test_torch_train import _batch, _tiny_model

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCC_CKPT = os.path.join(ROOT, "docs", "results", "occ_best_bf16.npz")
SHAPE = (120, 160)


def _args(**kw):
    base = dict(lr=1e-4, lr_schedule="cosine", warmup_steps=200,
                batch_size=2, epochs=3, max_steps=None)
    return argparse.Namespace(**dict(base, **kw))


def _optax_schedule(args, n_train):
    """``examples/train.py``'s learning rate, as that script builds it."""
    if args.lr_schedule != "cosine":
        return optax.constant_schedule(args.lr)
    steps_per_epoch = max(1, n_train // args.batch_size)
    total_steps = args.max_steps or steps_per_epoch * args.epochs
    return optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=args.lr,
        warmup_steps=min(args.warmup_steps, max(1, total_steps // 10)),
        decay_steps=total_steps, end_value=args.lr * 0.05)


def _linear_state(lr, seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    return TT.create_train_state(model, lr)


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="constant"), dict(warmup_steps=200),
    dict(warmup_steps=4, max_steps=30, lr=3e-4)],
    ids=["constant", "cosine", "cosine-warmup-4"])
def test_learning_rate_matches_optax_at_every_step(kw):
    args = _args(**kw)
    n_train = 20  # 10 steps an epoch, 30 steps in all
    want = _optax_schedule(args, n_train)
    state = _linear_state(cli.learning_rate(args, n_train))
    for count in range(30):
        got = state.optimizer.param_groups[0]["lr"]
        np.testing.assert_allclose(got, float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))
        state.optimizer.step()
        state.scheduler.step()
    if args.lr_schedule == "cosine":
        assert _linear_state(cli.learning_rate(args, n_train)) \
            .optimizer.param_groups[0]["lr"] == 0.0  # step 0 at lr 0


def test_adam_with_schedule_matches_optax_after_three_updates(rng):
    schedule = TT.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10, 5e-5)
    opt_schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10,
                                                      5e-5)
    state = _linear_state(schedule)
    params = {k: v.detach().numpy().copy()
              for k, v in state.model.named_parameters()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = optax.adam(opt_schedule)
    jp = dict(params)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in state.model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        state.optimizer.step()
        state.scheduler.step()
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k], rtol=1e-6,
                                   atol=1e-9)
        assert not np.allclose(p.detach().numpy(), params[k])


@pytest.fixture(scope="module")
def bank():
    return TT.CadPointBank.build(TD.ProceduralModels(), 21,
                                 max_solid_points=400, device="cpu")


def test_loss_without_occupancy_term_is_the_pose_loss(rng, bank):
    batch = _batch(rng)
    model = _tiny_model()
    off, m_off = TT.make_loss_fn(model, bank, occupancy_loss_term=False)(
        batch, True, train=False)
    on, m_on = TT.make_loss_fn(model, bank)(batch, True, train=False)
    assert sorted(m_off) == ["loss", "loss_add"]
    assert torch.equal(off, m_off["loss_add"])
    assert torch.equal(off, m_on["loss_add"])
    assert float(m_on["loss_occupancy"].detach()) != 0.0
    assert torch.equal(on, m_on["loss_add"] + m_on["loss_occupancy"])


def test_train_step_with_device_augmentation(rng, bank):
    batch = _batch(rng)
    batch["rgb"] = batch["rgb"].astype(np.uint8)
    del batch["sample_indices"]
    model = _tiny_model()
    state = TT.create_train_state(model)
    seen = []
    real = TT.augment_device.augment_batch

    def spy(generator, rgb, pcd):
        seen.append(generator.initial_seed())
        return real(generator, rgb, pcd)

    step = TT.make_train_step(model, bank, occupancy_loss_term=False,
                              augment=True)
    with mock.patch.object(TT.augment_device, "augment_batch", spy):
        for _ in range(2):
            state, metrics = step(state, batch, False, seed=3)
            assert np.isfinite(float(metrics["loss"]))
    want = [int(TT.step_generators(3, s, "cpu")[2].initial_seed())
            for s in range(2)]
    assert seen == want and seen[0] != seen[1]


def _records(rng, n, classes=(2, 5, 13)):
    return dict(class_id=rng.choice(classes, n).astype(np.int32),
                add=rng.uniform(0, 0.15, n).astype(np.float32),
                add_s=rng.uniform(0, 0.1, n).astype(np.float32),
                add_or_add_s=rng.uniform(0, 0.12, n).astype(np.float32))


def test_evaluator_matches_jax(rng):
    batches = [_records(rng, 6), _records(rng, 5)]
    t, j = TE.Evaluator(), JE.Evaluator()
    for b in batches:
        t.add_batch({k: torch.from_numpy(v) for k, v in b.items()})
        j.add_batch(b)
    got, want = t.summarize(), j.summarize()
    assert got == want and "main/add_or_add_s/auc" in got
    assert t.records() == j.records()
    t.reset()
    assert t.summarize() == {} == JE.Evaluator().summarize()
    r = _records(rng, 9)
    adds = {k: r[k] for k in ("add", "add_s")}
    assert (TE.summarize_records(r["class_id"], adds)
            == JE.summarize_records(r["class_id"], adds))


def test_log_report_rows_and_resume(tmp_path):
    rows = [({"main/loss": 0.5, "main/sps": 3.0}, 2, 0.5),
            ({"validation/main/auc": 0.25}, 4, 1.0)]

    def fill(mod, path):
        log = mod.LogReport(str(path))
        log.report(*rows[0])
        log = mod.LogReport(str(path))  # resumed: keeps the first row
        log.report(*rows[1])
        with open(path / "log.json") as f:
            on_disk = json.load(f)
        assert on_disk == log.log
        return [{k: v for k, v in r.items() if k != "elapsed_time"}
                for r in on_disk]

    got = fill(TR, tmp_path / "torch")
    assert got == fill(JR, tmp_path / "jax") and len(got) == 2
    TR.write_args(str(tmp_path / "torch"), {"lr": 1e-4})
    args = TR.load_args(str(tmp_path / "torch"))
    assert args["lr"] == 1e-4 and args["githash"] == JR.githash()
    assert {"hostname", "timestamp"} <= set(args)


def _npz_entries(path):
    with np.load(path) as data:
        return [(k, data[k].dtype, data[k].tobytes()) for k in data.files]


def _entries(d):
    return [(k, v.dtype, v.tobytes()) for k, v in d.items()]


def _tiny_occ():
    return TM.tiny_singleview3d(5, n_point=32, with_occupancy=True)


def test_export_params_npz_equals_jax(tmp_path):
    """The tiny model's random weights (not bf16-exact) exported by both
    packages."""
    variables, tmodel = carried(_tiny_occ)
    JC.export_params_npz(variables, str(tmp_path / "jax.npz"))
    TC.export_params_npz(tmodel, str(tmp_path / "torch.npz"))
    want = _npz_entries(tmp_path / "jax.npz")
    assert _npz_entries(tmp_path / "torch.npz") == want
    assert any("negative_slope" in e[0] for e in want)


def test_npz_entries_of_batch_norm_leaves_equal_jax():
    """The pretrained backbone's BatchNorm scales and statistics (not the
    identity): flax's keys in flax's order and JAX's bf16 rounding, without
    writing the 11M-weight archive."""
    import ml_dtypes

    variables, tmodel = carried(lambda: TM.tiny_singleview3d(
        5, n_point=32, with_occupancy=True, pretrained_resnet18=True))
    flat, _ = jax.tree_util.tree_flatten_with_path(variables)
    want = {"bf16:" + jax.tree_util.keystr(kp): np.asarray(leaf).astype(
        ml_dtypes.bfloat16).view(np.uint16) for kp, leaf in flat}
    got = TC.params_npz_entries(tmodel)
    assert _entries(got) == _entries(want)
    assert any("['batch_stats']" in k for k in got)
    assert any(k.endswith("['scale']") for k in got)


def test_jax_reads_the_port_export(tmp_path, rng):
    variables, tmodel = carried(_tiny_occ)
    path = str(tmp_path / "torch.npz")
    TC.export_params_npz(tmodel, path)
    jvars = JC.import_params_npz(variables, path)
    loaded = TC.import_params_npz(_tiny_occ(), path).eval()
    kw = _inputs(rng, B=2, S=64, P=32)
    jout = jax.jit(JM.tiny_singleview3d(
        5, n_point=32, with_occupancy=True).apply)(jvars, **kw)
    with torch.no_grad():
        tout = loaded(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    # the weights went through bf16
    w = dict(loaded.named_parameters())["conv1_rgb.weight"]
    assert torch.equal(w, w.to(torch.bfloat16).to(torch.float32))


def test_committed_checkpoint_round_trips():
    """``occ_best_bf16.npz`` imported and its entries made again: the
    file's own, in its order (the compressed write is covered above)."""
    model = TM.SingleView3D(n_fg_class=21, with_occupancy=True)
    TC.import_params_npz(model, OCC_CKPT)
    assert _entries(TC.params_npz_entries(model)) == _npz_entries(OCC_CKPT)


def test_import_backbone_npz(tmp_path):
    variables, tmodel = carried(_tiny_occ, seed=1)
    path = str(tmp_path / "backbone.npz")
    JC.export_params_npz(
        {"resnet_extractor": variables["params"]["resnet_extractor"]}, path)
    torch.manual_seed(2)
    model = _tiny_occ()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    TC.import_backbone_npz(model, path)
    donor = tmodel.state_dict()
    n = 0
    for k, v in model.state_dict().items():
        if k.startswith("resnet_extractor."):
            assert torch.equal(v, donor[k].to(torch.bfloat16).float()), k
            n += 1
        else:
            assert torch.equal(v, before[k]), k
    assert n > 0


def test_save_and_restore_latest(tmp_path, rng, bank):
    batch = _batch(rng)
    schedule = TT.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10, 5e-5)

    def fresh():
        return TT.create_train_state(_tiny_model(), schedule)

    state = fresh()
    step = TT.make_train_step(state.model, bank, occupancy_loss_term=False)
    for _ in range(3):
        step(state, batch, True, seed=1)
    ckpt = TC.CheckpointManager(str(tmp_path))
    assert ckpt.restore_latest(fresh()) is None
    ckpt.save_latest(state, state.step)
    restored = ckpt.restore_latest(fresh())
    assert restored.step == 3 and restored.scheduler.last_epoch == 3
    assert (restored.optimizer.param_groups[0]["lr"]
            == state.optimizer.param_groups[0]["lr"] == schedule(3))
    for a, b in zip(restored.optimizer.state_dict()["state"].values(),
                    state.optimizer.state_dict()["state"].values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    step(state, batch, True, seed=1)
    TT.make_train_step(restored.model, bank, occupancy_loss_term=False)(
        restored, batch, True, seed=1)
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert ckpt.save_best(state.model, "validation/main/auc", 0.5, "max")
    assert not ckpt.save_best(state.model, "validation/main/auc", 0.4, "max")
    best = ckpt.restore_best(_tiny_model(), "validation/main/auc")
    os.remove(tmp_path / "snapshot_model_best_validation_main_auc")
    from_npz = ckpt.restore_best(_tiny_model(), "validation/main/auc")
    for a, b, c in zip(best.state_dict().values(),
                       from_npz.state_dict().values(),
                       state.model.state_dict().values()):
        assert torch.equal(a, c)
        assert torch.equal(b, c.to(torch.bfloat16).float())


@pytest.fixture(scope="module")
def packed_set(tmp_path_factory):
    """Two synthetic frames of the port's generator (5 crops), packed."""
    root = tmp_path_factory.mktemp("fit_data")
    src = TD.SyntheticRGBDPoseEstimationDataset(
        split="train", n_frames=2, n_objects=(2, 3), image_shape=SHAPE)
    TD.reindex(str(root / "reindexed"), [src], n_workers=1, progress=False)
    TD.pack_reindexed(str(root / "reindexed"), str(root / "packed"),
                      progress=False)
    return str(root / "packed")


def _fit(out, data, **kw):
    torch.manual_seed(0)
    model = TM.tiny_singleview3d(21, n_point=32, with_occupancy=True)
    return TLoop.fit(
        model=model, models_bank=TD.ProceduralModels(),
        train_dataset=TD.PackedPoseDataset(data, augmentation=True),
        val_dataset=TD.PackedPoseDataset(data, split="val"),
        out_dir=out, transform_train=TD.Transform(True, True),
        transform_val=TD.Transform(False, True), n_fg_class=21,
        batch_size=2, epochs=2, eval_interval=1.0, log_interval=1,
        val_batch_size=4, device_augment=True, device="cpu", **kw)


def test_fit_evaluates_snapshots_and_resumes(tmp_path, packed_set):
    out = str(tmp_path / "run")
    calls = []
    real = TLoop.make_dp_train_step

    def spy_make(*args, **kw):
        step = real(*args, **kw)

        def spied(state, batch, use_symmetric, seed=0):
            calls.append((state.step, bool(use_symmetric)))
            return step(state, batch, use_symmetric, seed=seed)

        return spied

    with mock.patch.object(TLoop, "make_dp_train_step", spy_make):
        state, summary = _fit(out, packed_set, args_dict={"tag": "a"})
    n = len(TD.PackedPoseDataset(packed_set))
    spe = n // 2
    assert state.step == 2 * spe
    assert calls == [(s, s >= spe) for s in range(2 * spe)]
    assert "main/add_or_add_s/auc" in summary
    names = set(os.listdir(out))
    for name in ("args.json", "log.json", "timing.json",
                 "snapshot_trainer_latest",
                 "snapshot_model_best_validation_main_auc",
                 "snapshot_model_best_validation_main_auc.npz",
                 "snapshot_model_best_validation_main_add_or_add_s",
                 "snapshot_model_best_validation_main_add_or_add_s.npz"):
        assert name in names, name
    with open(os.path.join(out, "log.json")) as f:
        log = json.load(f)
    evals = [r for r in log if "main/add_or_add_s/auc" in r]
    assert [r["iteration"] for r in evals] == [spe, 2 * spe]
    assert all(np.isfinite(r["main/loss"]) for r in log if "main/loss" in r)
    with open(os.path.join(out, "timing.json")) as f:
        timing = json.load(f)
    assert len(timing["wait_ms"]) == 2 * spe
    n_val = len(TD.PackedPoseDataset(packed_set, split="val"))
    assert len(timing["eval_ms_per_batch"]) == 2 * (n_val // 4)

    calls.clear()
    with mock.patch.object(TLoop, "make_dp_train_step", spy_make):
        state, _ = _fit(out, packed_set, resume=True, max_steps=2 * spe + 1)
    assert state.step == 2 * spe + 1
    assert calls == [(2 * spe, True)]
    with open(os.path.join(out, "log.json")) as f:
        assert json.load(f)[:len(log)] == log


def test_train_cli_on_a_packed_set(tmp_path, packed_set):
    out = str(tmp_path / "run")
    state, summary = cli.main([
        "--out", out, "--data", packed_set, "--tiny", "--max-steps", "2",
        "--device", "cpu", "--batch-size", "2", "--n-point", "32",
        "--min-visibility", "0", "--with-occupancy", "--lr-schedule",
        "cosine", "--warmup-steps", "1", "--log-interval", "1"])
    assert state.step == 2 and summary == {}  # fewer than 48 val crops
    with open(os.path.join(out, "args.json")) as f:
        args = json.load(f)
    assert args["tiny"] and args["device"] == "cpu"
    with open(os.path.join(out, "log.json")) as f:
        assert [r["iteration"] for r in json.load(f)] == [1, 2]
    assert os.path.isfile(os.path.join(out, "snapshot_trainer_latest"))
