"""The port's train step and its losses against the JAX package on the CPU.

Same float32 inputs, made from a seed with numpy, through
``morefusion_tpu`` (JAX on the CPU) and ``morefusion_tpu_torch``; the tiny
SingleView3D (``tiny_singleview3d``, B = 2, 64 x 64 crops, 32 points, 32^3
grids) carries its weights across with ``torch_to_flax``. Both sides get the
same ``sample_indices`` and run with dropout off (the two frameworks draw
different random bits), so the whole JAX step, which splits its own key, is
not compared: its loss and gradients are, and Adam apart.

Tolerances (float32 on both sides, sums in other orders):
- losses and distances: rtol 1e-5, atol 1e-6; their gradients atol 1e-5;
- gradients are compared with JAX given the port's correspondences. JAX's
  ``nn`` forms ``|q|^2 + |r|^2 - 2 q.r``, which at 0.8 m from the camera
  picks a farther point at ~0.1% of the queries (``test_torch_knn.py``),
  and its min-distance scan (``tdf._scan_core``) forms ``c2 + p2 - 2 c.p``
  with ``|c|^2`` up to ~3000 voxel^2, which swaps winners at near-ties; a
  swapped correspondence moves that point's gradient term. So where
  gradients are compared, the JAX loss runs with both searches swapped for
  the exact argmin of ``(dx*dx + dy*dy) + dz*dz``; values are compared with
  the JAX package as it is;
- the occupancy loss: atol 1e-5 (JAX forms the voxel distance as
  ``c2 + p2 - 2 c.p``, the port as a sum of squares), gradients rtol 1e-4
  and atol 1e-5 (sums over 32^3 voxels);
- the tiny model's loss: rtol 1e-4; each parameter's gradient within 1e-4
  of its own norm plus 1e-6 of the whole gradient's norm
  (``|g - g_jax| <= 1e-4 |g_jax| + 1e-6 |G_jax|``): the backbone's
  gradients are 1e-5 to 1e-6 of the heads' and carry float32 rounding of
  the sums above them, summed in other orders;
- Adam after two steps against optax: rtol 1e-6, atol 1e-9;
- the CAD point bank: bit for bit.
"""

import contextlib
import dataclasses
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

from morefusion_tpu import functions as JF
from morefusion_tpu import models as JM
from morefusion_tpu.functions import loss as jloss_module
from morefusion_tpu.functions import tdf as jtdf
from morefusion_tpu.datasets import ProceduralModels as JProceduralModels
from morefusion_tpu.models import losses as JL
from morefusion_tpu.training import trainer as JT
from morefusion_tpu_torch import functions as TF
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.datasets import ProceduralModels
from morefusion_tpu_torch.models import losses as TL
from morefusion_tpu_torch.models import pspnet
from morefusion_tpu_torch.training import trainer as TT
from tests.test_torch_model import _flax_to_np, torch_to_flax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SYMMETRIC_CLASS, ASYMMETRIC_CLASS = 13, 2  # bowl, cracker box
V = 32


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def _poses(g, B, M, spread=0.02):
    q_true = g.normal(size=(B, 4)).astype(np.float32)
    t_true = (g.uniform(-0.05, 0.05, (B, 3)) + [0, 0, 0.8]).astype(np.float32)
    q_pred = (q_true[:, None] + g.normal(0, 0.2, (B, M, 4))).astype(np.float32)
    t_pred = (t_true[:, None] + g.normal(0, spread, (B, M, 3))).astype(
        np.float32)
    return q_true, t_true, q_pred, t_pred


@pytest.fixture(scope="module")
def bank():
    """A bank at test size: 400 solid points per class in place of 3000."""
    return TT.CadPointBank.build(ProceduralModels(), 21,
                                 max_solid_points=400, device="cpu")


def _exact_nn(ref, query):
    d = query[:, None, :] - ref[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return jax.lax.stop_gradient(jnp.argmin(d2, axis=-1).astype(jnp.int32))


def _exact_scan_core(ip, valid, dims, chunk, n=64):
    """``tdf._scan_core`` with the port's arithmetic, ``n`` points a pass."""
    c = jtdf._voxel_centers(dims, ip.dtype)
    P = ip.shape[0]
    Pp = -(-P // n) * n
    ip = jnp.zeros((Pp, 3), ip.dtype).at[:P].set(ip).reshape(-1, n, 3)
    valid = jnp.zeros((Pp,), bool).at[:P].set(valid).reshape(-1, n)

    def body(carry, xs):
        best, arg = carry
        pts, ok, base = xs
        d = c[:, None, :] - pts[None, :, :]  # (V, n, 3)
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
              + d[..., 2] * d[..., 2])
        d2 = jnp.where(ok[None, :], d2, jnp.inf)
        k = jnp.argmin(d2, axis=1)
        m = jnp.min(d2, axis=1)
        better = m < best
        return (jnp.where(better, m, best),
                jnp.where(better, base + k.astype(jnp.int32), arg)), None

    init = (jnp.full((c.shape[0],), jnp.inf, ip.dtype),
            jnp.full((c.shape[0],), -1, jnp.int32))
    bases = jnp.arange(ip.shape[0], dtype=jnp.int32) * n
    (best, arg), _ = jax.lax.scan(body, init, (ip, valid, bases))
    return best, arg


@contextlib.contextmanager
def _jax_exact_search():
    """The JAX losses with the port's correspondences (see the docstring)."""
    with mock.patch.object(jloss_module, "nn", _exact_nn), \
            mock.patch.object(jtdf, "_scan_core", _exact_scan_core):
        yield


def _jax_bank(bank):
    return JT.CadPointBank(**{
        f.name: jnp.asarray(getattr(bank, f.name).numpy())
        for f in dataclasses.fields(bank)})


def test_cad_point_bank_matches_jax_bit_for_bit():
    want = JT.CadPointBank.build(JProceduralModels(), 21, with_solid=True)
    bank = TT.CadPointBank.build(ProceduralModels(), 21, device="cpu")
    for name in ("points", "symmetric", "solid_points", "solid_sdf",
                 "solid_mask"):
        got = getattr(bank, name).numpy()
        ref = np.asarray(getattr(want, name))
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert bank.points[0].abs().sum() == 0  # the background row


def test_translation_matrix(rng):
    t = rng.normal(size=(2, 5, 3)).astype(np.float32)
    _close(TF.translation_matrix(_t(t)), JF.translation_matrix(t))
    _close(TF.translation_matrix(_t(t[0, 0])), JF.translation_matrix(t[0, 0]))


@pytest.mark.parametrize("symmetric", [False, True])
def test_average_distance(rng, bank, symmetric):
    B, M = 2, 6
    pts = bank.points[[SYMMETRIC_CLASS, ASYMMETRIC_CLASS]].numpy()
    q_true, t_true, q_pred, t_pred = _poses(rng, B, M)
    w = rng.uniform(0.5, 1.5, (B, M)).astype(np.float32)

    def jf(q, t):
        T_true = JF.transformation_matrix(q_true, t_true)
        T_pred = jax.vmap(JF.transformation_matrix)(q, t)
        d = jax.vmap(JF.average_distance, (0, 0, 0, None))(
            pts, T_true, T_pred, symmetric)
        return jnp.sum(d * w), d

    _, jd = jax.jit(jf)(q_pred, t_pred)
    with _jax_exact_search():
        jgq, jgt = jax.jit(jax.grad(jf, (0, 1), has_aux=True))(
            q_pred, t_pred)[0]
    tq, tt = _t(q_pred, True), _t(t_pred, True)
    d = TF.average_distance(
        _t(pts), TF.transformation_matrix(_t(q_true), _t(t_true)),
        TF.transformation_matrix(tq, tt), symmetric)
    (d * _t(w)).sum().backward()
    _close(d, jd)
    _close(tq.grad, jgq, atol=1e-5)
    _close(tt.grad, jgt, atol=1e-5)


def test_average_distance_both(rng, bank):
    pts = bank.points[[SYMMETRIC_CLASS, ASYMMETRIC_CLASS]].numpy()
    q_true, t_true, q_pred, t_pred = _poses(rng, 2, 4)
    T_true = JF.transformation_matrix(q_true, t_true)
    T_pred = jax.vmap(JF.transformation_matrix)(q_pred, t_pred)
    jadd, jadds = jax.jit(jax.vmap(JF.average_distance_both))(
        pts, T_true, T_pred)
    add, adds = TF.average_distance_both(_t(pts), _t(T_true), _t(T_pred))
    _close(add, jadd)
    _close(adds, jadds)
    assert (adds <= add + 1e-6).all()  # a nearest point is never farther


def test_densefusion_confidence_loss(rng):
    add = rng.uniform(0, 0.1, (3, 20)).astype(np.float32)
    conf = rng.uniform(0.01, 1, (3, 20)).astype(np.float32)
    conf[0, :5] = 0.0  # failures, masked out
    conf[2] = 0.0  # a lane with none kept

    def jf(a, c):
        per = jax.vmap(JF.densefusion_confidence_loss)(a, c)
        return jnp.sum(per * jnp.arange(1.0, 4.0)), per

    (_, jper), (jga, jgc) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        add, conf)
    ta, tc = _t(add, True), _t(conf, True)
    per = TF.densefusion_confidence_loss(ta, tc)
    (per * torch.arange(1.0, 4.0)).sum().backward()
    _close(per, jper)
    _close(ta.grad, jga, atol=1e-5)
    _close(tc.grad, jgc, atol=1e-5)
    assert per[2] == 0


def _pose_inputs(rng, bank, P=16):
    q_true, t_true, q_pred, t_pred = _poses(rng, 2, P)
    conf = rng.uniform(0.05, 0.95, (2, P)).astype(np.float32)
    cid = np.array([SYMMETRIC_CLASS, ASYMMETRIC_CLASS])
    return dict(quaternion_pred=q_pred, translation_pred=t_pred,
                confidence_pred=conf, quaternion_true=q_true,
                translation_true=t_true,
                cad_points=bank.points[cid].numpy(),
                symmetric=bank.symmetric[cid].numpy())


def test_pose_loss(rng, bank):
    kw = _pose_inputs(rng, bank)
    diff = ("quaternion_pred", "translation_pred", "confidence_pred")

    def jf(*args):
        return JL.pose_loss(**dict(kw, **dict(zip(diff, args))))

    jv = jax.jit(jf)(*(kw[k] for k in diff))
    with _jax_exact_search():
        jg = jax.jit(jax.grad(jf, (0, 1, 2)))(*(kw[k] for k in diff))
    tkw = {k: _t(v, k in diff) for k, v in kw.items()}
    loss = TL.pose_loss(**tkw)
    loss.backward()
    _close(loss, jv)
    for k, g in zip(diff, jg):
        _close(tkw[k].grad, g, atol=1e-5)


def _occupancy_inputs(rng, bank, P=16):
    kw = _pose_inputs(rng, bank, P)
    center = kw["translation_true"]
    for k in ("cad_points", "symmetric", "quaternion_true",
              "translation_true"):
        del kw[k]
    cid = np.array([SYMMETRIC_CLASS, ASYMMETRIC_CLASS])
    pitch = np.array([0.012, 0.01], np.float32)
    kw.update(
        solid_points=bank.solid_points[cid].numpy(),
        solid_sdf=bank.solid_sdf[cid].numpy(),
        solid_mask=bank.solid_mask[cid].numpy(),
        pitch=pitch,
        origin=(center - pitch[:, None] * (V / 2 - 0.5)).astype(np.float32),
        grid_target=(rng.rand(2, V, V, V) < 0.3).astype(np.float32),
        grid_nontarget_empty=(rng.rand(2, V, V, V) < 0.3).astype(np.float32),
    )
    top2 = np.sort(kw["confidence_pred"], axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-4).all(), "near-tie in argmax"
    return kw


def test_occupancy_loss(rng, bank):
    kw = _occupancy_inputs(rng, bank)
    diff = ("quaternion_pred", "translation_pred")

    def jf(*args):
        return JL.occupancy_loss(**dict(kw, **dict(zip(diff, args))))

    jv = jax.jit(jf)(*(kw[k] for k in diff))
    with _jax_exact_search():
        jg = jax.jit(jax.grad(jf, (0, 1)))(*(kw[k] for k in diff))
    tkw = {k: _t(v, k in diff) for k, v in kw.items()}
    loss = TL.occupancy_loss(**tkw)
    loss.backward()
    assert abs(float(jv)) > 1e-3  # the poses put the objects in the grids
    _close(loss, jv, atol=1e-5)
    for k, g in zip(diff, jg):
        _close(tkw[k].grad, g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tied_confidence", [False, True])
def test_evaluate_add(rng, bank, tied_confidence):
    """With ``tied_confidence`` each lane's top confidence is shared by two
    poses, and both sides take the first of them."""
    kw = _pose_inputs(rng, bank)
    if tied_confidence:
        conf = kw["confidence_pred"]
        conf[:, [3, 9]] = conf.max(axis=1, keepdims=True) + 0.01
    want = jax.jit(lambda kw: JL.evaluate_add(**kw))(kw)
    got = TL.evaluate_add(**{k: _t(v) for k, v in kw.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


# ------------------------------------------------------------- the model


def _batch(rng, B=2, S=64, n_point=32):
    rgb = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    pcd = rng.uniform(-0.08, 0.08, (B, S, S, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    pcd[rng.rand(B, S, S) < 0.3] = np.nan
    mask = ~np.isnan(pcd).any(-1)
    q = rng.normal(size=(B, 4)).astype(np.float32)
    pitch = np.full(B, 0.01, np.float32)
    return dict(
        class_id=np.array([SYMMETRIC_CLASS, ASYMMETRIC_CLASS], np.int32),
        rgb=rgb, pcd=pcd,
        quaternion_true=q / np.linalg.norm(q, axis=1, keepdims=True),
        translation_true=np.float32(rng.uniform(-0.02, 0.02, (B, 3))
                                    + [0, 0, 0.8]),
        origin=np.float32(np.array([0, 0, 0.8]) - pitch[:, None] * 15.5),
        pitch=pitch,
        grid_target=(rng.rand(B, V, V, V) < 0.2).astype(np.float32),
        grid_nontarget_empty=(rng.rand(B, V, V, V) < 0.3).astype(np.float32),
        sample_indices=np.stack([
            rng.choice(np.flatnonzero(mask[b].ravel()), n_point,
                       replace=False) for b in range(B)]).astype(np.int32),
    )


def _tiny_model(seed=0):
    torch.manual_seed(seed)
    return TM.tiny_singleview3d(21, n_point=32, with_occupancy=True)


def test_loss_fn_value_and_grads_match_jax(rng, bank):
    batch = _batch(rng)
    model = _tiny_model()
    loss_fn = TT.make_loss_fn(model, bank)
    loss, metrics = loss_fn(batch, True, train=False)
    loss.backward()
    assert float(metrics["loss_occupancy"].detach()) != 0.0

    jmodel = JM.tiny_singleview3d(21, n_point=32, with_occupancy=True)
    jbank = _jax_bank(bank)
    cid = batch["class_id"]

    def jloss(params):
        quat, trans, conf = jmodel.apply(
            params, class_id=cid, rgb=batch["rgb"], pcd=batch["pcd"],
            pitch=batch["pitch"], origin=batch["origin"],
            grid_nontarget_empty=batch["grid_nontarget_empty"],
            sample_indices=batch["sample_indices"], train=False)
        add = JL.pose_loss(
            quaternion_pred=quat, translation_pred=trans,
            confidence_pred=conf,
            quaternion_true=batch["quaternion_true"],
            translation_true=batch["translation_true"],
            cad_points=jbank.points[cid], symmetric=jbank.symmetric[cid])
        occ = JL.occupancy_loss(
            quaternion_pred=quat, translation_pred=trans,
            confidence_pred=conf, solid_points=jbank.solid_points[cid],
            solid_sdf=jbank.solid_sdf[cid], solid_mask=jbank.solid_mask[cid],
            pitch=batch["pitch"], origin=batch["origin"],
            grid_target=batch["grid_target"],
            grid_nontarget_empty=batch["grid_nontarget_empty"])
        top2 = jnp.sort(conf, axis=1)[:, -2:]
        return add + occ, (add, occ, top2[:, 1] - top2[:, 0])

    with _jax_exact_search():
        (jv, (jadd, jocc, gap)), jgrads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(torch_to_flax(model))
    assert (np.asarray(gap) > 1e-4).all(), "near-tie in the argmax"
    _close(metrics["loss_add"], jadd, rtol=1e-4)
    _close(metrics["loss_occupancy"], jocc, rtol=1e-4, atol=1e-6)
    _close(loss, jv, rtol=1e-4)

    want = TM.params_from_jax(_flax_to_np(jgrads))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    total = float(torch.cat([g.reshape(-1) for g in want.values()]).norm())
    for name, p in got.items():
        err = float((p.grad - want[name]).norm())
        assert err <= 1e-4 * float(want[name].norm()) + 1e-6 * total, name


def test_adam_matches_optax_after_two_steps(rng):
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    tx = optax.adam(1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    model = torch.nn.Module()
    for k, v in params.items():
        model.register_parameter(k, torch.nn.Parameter(_t(v)))
    state = TT.create_train_state(model)
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = _t(g[k])
        state.optimizer.step()
    for k, p in model.named_parameters():
        _close(p, jp[k], rtol=1e-6, atol=1e-9)
        assert not np.allclose(p.detach().numpy(), params[k])


def test_dropout_is_reproducible_and_scaled():
    x = torch.rand(4, 8, 16, 16) + 0.5
    for rate in pspnet.DROPOUT_RATES:
        a = pspnet.dropout(x, rate, torch.Generator().manual_seed(3))
        b = pspnet.dropout(x, rate, torch.Generator().manual_seed(3))
        c = pspnet.dropout(x, rate, torch.Generator().manual_seed(4))
        assert torch.equal(a, b) and not torch.equal(a, c)
        kept = a != 0
        torch.testing.assert_close(a[kept], x[kept] / (1 - rate))
        # 8192 draws: the kept share is within 5 sigma of 1 - rate
        sigma = (rate * (1 - rate) / x.numel()) ** 0.5
        assert abs(kept.float().mean() - (1 - rate)) < 5 * sigma


def test_dropout_only_in_training(rng):
    batch = _batch(rng)
    model = _tiny_model()
    kw = {k: torch.as_tensor(batch[k]) for k in (
        "class_id", "rgb", "pcd", "pitch", "origin", "grid_nontarget_empty",
        "sample_indices")}
    with torch.no_grad():
        off = model(**kw)
        off_again = model(**kw, train=False,
                          dropout_generator=torch.Generator().manual_seed(0))
        on = [model(**kw, train=True,
                    dropout_generator=torch.Generator().manual_seed(s))
              for s in (0, 0, 1)]
    for a, b in zip(off, off_again):
        assert torch.equal(a, b)
    for a, b, c, d in zip(on[0], on[1], on[2], off):
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert not torch.equal(a, d)
    with pytest.raises(ValueError):
        model(**kw, train=True)


def test_step_generators_follow_seed_and_step():
    def draw(seed, step):
        return [torch.rand(4, generator=g)
                for g in TT.step_generators(seed, step, "cpu")]

    a, b = draw(0, 5), draw(0, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])  # sampling and dropout differ
    for other in (draw(0, 6), draw(1, 5)):
        assert not any(torch.equal(x, y) for x, y in zip(a, other))


def test_train_loop_three_steps_on_the_cpu(rng, bank):
    batch = _batch(rng)
    del batch["sample_indices"]  # the step draws its own
    model = _tiny_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TT.create_train_state(model)
    step = TT.make_train_step(model, bank)
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch, True, seed=7)
        assert sorted(metrics) == ["loss", "loss_add", "loss_occupancy"]
        losses.append(float(metrics["loss"]))
    assert state.step == 3
    assert np.isfinite(losses).all(), losses
    changed = [not torch.equal(before[k], v)
               for k, v in model.state_dict().items()]
    assert all(changed)


def test_eval_step_matches_jax(rng, bank):
    batch = _batch(rng)
    model = _tiny_model()
    out = TT.make_eval_step(model, bank)(batch)

    jmodel = JM.tiny_singleview3d(21, n_point=32, with_occupancy=True)
    cid = batch["class_id"]
    inputs = {k: batch[k] for k in (
        "class_id", "rgb", "pcd", "pitch", "origin", "grid_nontarget_empty",
        "sample_indices")}
    quat, trans, conf = jax.jit(lambda p, kw: jmodel.apply(p, **kw))(
        torch_to_flax(model), inputs)
    jbank = _jax_bank(bank)
    want = JL.evaluate_add(
        quaternion_pred=quat, translation_pred=trans, confidence_pred=conf,
        quaternion_true=batch["quaternion_true"],
        translation_true=batch["translation_true"],
        cad_points=jbank.points[cid], symmetric=jbank.symmetric[cid])
    for k in want:
        _close(out[k], want[k], rtol=1e-4)
    np.testing.assert_array_equal(out["class_id"].numpy(), cid)


def test_stack_examples(rng):
    ex = [{"a": rng.rand(3), "b": i} for i in range(4)]
    out = TT.stack_examples(ex)
    assert out["a"].shape == (4, 3) and list(out["b"]) == [0, 1, 2, 3]


def test_backbone_backward_with_four_threads():
    """A permuted (channels-last) input to the backbone sent the CPU
    backward through a oneDNN convolution path that crashes with three or
    more threads; the backbone now takes a contiguous NCHW input."""
    code = (
        "import torch\n"
        "torch.set_num_threads(4)\n"
        "from morefusion_tpu_torch.models import DilatedResNet18\n"
        "torch.manual_seed(0)\n"
        "m = DilatedResNet18(base_width=8)\n"
        "m(torch.rand(2, 64, 64, 3) * 255).sum().backward()\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
