"""bf16 serving and the pretrained-ResNet18 backbone against ``morefusion_tpu``.

bf16: a tiny SingleView3D with one set of weights, carried across by
``variables_from_jax``, and the same seeded inputs and ``sample_indices``
run through JAX at ``compute_dtype=jnp.bfloat16`` and ``jnp.float32`` and
through the port in bf16. Per output (quaternion, translation,
confidence), the port's bf16 must be no farther from JAX's bf16 than JAX's
bf16 is from JAX's fp32 on the same inputs: that gap is the tolerance. On
these inputs it measured 3.3e-3 (quaternion), 6.9e-6 (translation, m) and
1.3e-4 (confidence) with the occupancy branch, 1.4e-3, 7.8e-6 and 9.2e-5
without it, and 6.1e-3, 5.2e-6 and 1.9e-4 with the pretrained backbone; the
port's bf16 stood 1.7e-3, 3.5e-6 and 4.6e-5; 1.1e-3, 5.5e-6 and 7.0e-5; and
2.7e-3, 3.9e-6 and 6.9e-5 from JAX's. The scatter-mean sums in fp32 in the
port (a deliberate difference, ``functions/voxelization.py``).

fp32: ``DilatedResNet34`` and ``ResNet18Extractor`` (BatchNorm statistics
that are not the identity) agree with JAX within 1e-5; ``model.train()``
leaves the BatchNorm frozen, and no gradient reaches below res3. The
torchvision-layout mapping is held to JAX's ``convert_torchvision_resnet18``
followed by ``apply`` on a random state dict with torchvision's key names,
within 1e-5 of the features' largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from morefusion_tpu import functions as JF
from morefusion_tpu import models as JM
from morefusion_tpu.models import convert_torch as JCT
from morefusion_tpu_torch import functions as TF
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.models.layers import FrozenBatchNorm2d
from tests.test_torch_model import _inputs

torch.set_num_threads(2)

_NORM = {"weight": ("params", "scale"), "bias": ("params", "bias"),
         "running_mean": ("batch_stats", "mean"),
         "running_var": ("batch_stats", "var")}


def torch_to_flax_variables(model):
    """A port model's parameters and BatchNorm statistics as a flax variables
    tree (the inverse of ``variables_from_jax``)."""
    tree = {}
    for mname, mod in model.named_modules():
        leaves = list(mod.named_parameters(recurse=False))
        leaves += list(mod.named_buffers(recurse=False))
        for name, t in leaves:
            a = t.detach().numpy()
            if isinstance(mod, (nn.GroupNorm, FrozenBatchNorm2d)):
                col, leaf = _NORM[name]
            elif isinstance(mod, nn.PReLU):
                col, leaf, a = "params", "negative_slope", a.reshape(())
            elif name == "weight":
                col, leaf = "params", "kernel"
                a = a.T if a.ndim == 2 else a.transpose(
                    *range(2, a.ndim), 1, 0)
            else:
                col, leaf = "params", name
            node = tree.setdefault(col, {})
            for p in mname.split(".") if mname else []:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(a)
    return tree


def randomize_batch_stats(model, seed):
    """BatchNorm statistics and affine parameters that are not the
    identity, drawn from ``seed``."""
    g = np.random.RandomState(seed)
    for mod in model.modules():
        if isinstance(mod, FrozenBatchNorm2d):
            c = mod.running_mean.shape[0]
            for t, lo, hi in ((mod.weight, 0.5, 1.5), (mod.bias, -0.1, 0.1),
                              (mod.running_mean, -0.1, 0.1),
                              (mod.running_var, 0.5, 1.5)):
                t.data.copy_(torch.from_numpy(
                    g.uniform(lo, hi, c).astype(np.float32)))
    return model


def carried(make, seed=0):
    """One port model made under ``seed`` (BN statistics randomized), its
    flax variables, and a second port model loaded from them."""
    torch.manual_seed(seed)
    variables = torch_to_flax_variables(randomize_batch_stats(make(), seed))
    tmodel = make()
    tmodel.load_state_dict(TM.variables_from_jax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    return variables, tmodel.eval()


def torchvision_state_dict(seed):
    """A random ResNet18 state dict with torchvision's key names; conv
    weights scaled by their fan-in so that the features stay near 1."""
    g = np.random.RandomState(seed)
    sd = {}

    def conv(key, o, i, k):
        sd[f"{key}.weight"] = torch.from_numpy(g.normal(
            0, (i * k * k) ** -0.5, (o, i, k, k)).astype(np.float32))

    def bn(key, c):
        for leaf, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.1, 0.1),
                             ("running_mean", -0.1, 0.1),
                             ("running_var", 0.5, 1.5)):
            sd[f"{key}.{leaf}"] = torch.from_numpy(
                g.uniform(lo, hi, c).astype(np.float32))
        sd[f"{key}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    chans = {1: (64, 64), 2: (64, 128), 3: (128, 256), 4: (256, 512)}
    for layer, (cin, cout) in chans.items():
        for sub in (0, 1):
            key = f"layer{layer}.{sub}"
            conv(f"{key}.conv1", cout, cin if sub == 0 else cout, 3)
            bn(f"{key}.bn1", cout)
            conv(f"{key}.conv2", cout, cout, 3)
            bn(f"{key}.bn2", cout)
            if layer > 1 and sub == 0:
                conv(f"{key}.downsample.0", cout, cin, 1)
                bn(f"{key}.downsample.1", cout)
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _rgb(rng, B=2, S=64):
    return rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _max_gap(a, b):
    return [float(np.abs(np.asarray(x, np.float64)
                         - np.asarray(y, np.float64)).max())
            for x, y in zip(a, b)]


@pytest.mark.parametrize("with_occupancy,pretrained", [
    (True, False), (False, False), (True, True)],
    ids=["occ", "noocc", "occ-pretrained"])
def test_bf16_within_jax_bf16_gap(rng, with_occupancy, pretrained):
    kw = _inputs(rng, B=2, S=80 if not pretrained else 48, P=32)
    if not with_occupancy:
        del kw["grid_nontarget_empty"]
    cfg = dict(n_point=32, with_occupancy=with_occupancy,
               pretrained_resnet18=pretrained)
    variables, _ = carried(lambda: TM.tiny_singleview3d(5, **cfg))
    jout = {dt: jax.jit(JM.tiny_singleview3d(
        5, compute_dtype=dt, **cfg).apply)(variables, **kw)
        for dt in (jnp.float32, jnp.bfloat16)}
    tmodel = TM.tiny_singleview3d(5, compute_dtype=torch.bfloat16, **cfg)
    tmodel.load_state_dict(TM.variables_from_jax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    with torch.no_grad():
        tout = tmodel.eval()(**{k: torch.from_numpy(v)
                                for k, v in kw.items()})
    for t, j in zip(tout, jout[jnp.bfloat16]):
        assert t.dtype == torch.float32 and t.shape == j.shape
        assert np.isfinite(t.numpy()).all()
    gap = _max_gap(jout[jnp.bfloat16], jout[jnp.float32])
    err = _max_gap([t.numpy() for t in tout], jout[jnp.bfloat16])
    assert min(gap) > 0.0  # bf16 did compute in bf16
    for name, e, g in zip(("quaternion", "translation", "confidence"), err,
                          gap):
        assert e <= g, f"{name}: port bf16 {e} from JAX bf16, gap {g}"


def test_fp32_model_computes_as_before(rng):
    """An fp32 port model is the stock layers (fused bias): the pretrained
    path at fp32 agrees with JAX within 1e-5."""
    kw = _inputs(rng, B=2, S=48, P=32)
    cfg = dict(n_point=32, with_occupancy=True, pretrained_resnet18=True)
    variables, tmodel = carried(lambda: TM.tiny_singleview3d(5, **cfg))
    jout = jax.jit(JM.tiny_singleview3d(5, **cfg).apply)(variables, **kw)
    with torch.no_grad():
        tout = tmodel(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5)


def test_dilated_resnet34_matches_jax(rng):
    variables, tmodel = carried(lambda: TM.DilatedResNet34(base_width=8))
    rgb = _rgb(rng)
    want = jax.jit(JM.DilatedResNet34(base_width=8).apply)(variables, rgb)
    with torch.no_grad():
        got = _nhwc(tmodel(torch.from_numpy(rgb)))
    assert got.shape == want.shape == (2, 8, 8, 64)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_resnet18_extractor_matches_jax(rng):
    variables, tmodel = carried(TM.ResNet18Extractor)
    assert set(variables) == {"params", "batch_stats"}
    rgb = _rgb(rng)
    want = jax.jit(JM.ResNet18Extractor().apply)(variables, rgb)
    with torch.no_grad():
        got = _nhwc(tmodel(torch.from_numpy(rgb)))
    assert got.shape == want.shape == (2, 8, 8, 512)
    assert 0.1 < float(np.abs(want).max()) < 100.0
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_resnet18_extractor_frozen_in_training(rng):
    _, model = carried(TM.ResNet18Extractor)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(_rgb(rng))
    with torch.no_grad():
        want = model.eval()(x)
    model.train()
    got = model(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for name, p in model.named_parameters():
        below_res3 = name.startswith(("Conv_0", "BatchNorm_0",
                                      "BNBasicBlock_0", "BNBasicBlock_1"))
        assert (p.grad is None) == below_res3, name
        if not below_res3:
            assert float(p.grad.abs().sum()) > 0.0, name


def test_torchvision_mapping_matches_jax(rng):
    sd = torchvision_state_dict(0)
    rgb = _rgb(rng, B=1)
    want = jax.jit(JM.ResNet18Extractor().apply)(
        JCT.convert_torchvision_resnet18(sd), rgb)
    model = TM.ResNet18Extractor()
    model.load_state_dict(TM.convert_torchvision_resnet18(sd), strict=True)
    with torch.no_grad():
        got = _nhwc(model.eval()(torch.from_numpy(rgb)))
    # fp32 sums in other orders through 17 convs: 1e-5 of the largest
    # feature (38.8 here; 3.4e-5 apart)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    # a checkpoint that wraps its weights under "state_dict" loads too
    wrapped = TM.convert_torchvision_resnet18({"state_dict": sd})
    assert wrapped.keys() == model.state_dict().keys()


def test_graft_resnet18_matches_jax(rng):
    sd = torchvision_state_dict(2)
    cfg = dict(n_point=8, pretrained_resnet18=True)
    kw = _inputs(rng, B=1, S=32, P=8)
    del kw["grid_nontarget_empty"]
    variables, tmodel = carried(lambda: TM.tiny_singleview3d(2, **cfg))
    grafted = JCT.graft_resnet18(variables,
                                 JCT.convert_torchvision_resnet18(sd))
    want = jax.jit(JM.tiny_singleview3d(2, **cfg).apply)(grafted, **kw)
    state = TM.graft_resnet18(tmodel.state_dict(),
                              TM.convert_torchvision_resnet18(sd))
    tmodel.load_state_dict(state, strict=True)
    torch.testing.assert_close(
        tmodel.resnet_extractor.Conv_0.weight, sd["conv1.weight"])
    with torch.no_grad():
        got = tmodel(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5)


def test_variables_from_jax_renames_norm_leaves():
    tree = {"params": {"a": {"scale": np.ones(3, np.float32),
                             "bias": np.zeros(3, np.float32)},
                       "c": {"kernel": np.ones((2, 4), np.float32)}},
            "batch_stats": {"a": {"mean": np.full(3, 2.0, np.float32),
                                  "var": np.full(3, 3.0, np.float32)}}}
    state = TM.variables_from_jax(tree)
    assert sorted(state) == ["a.bias", "a.running_mean", "a.running_var",
                             "a.weight", "c.weight"]
    assert state["c.weight"].shape == (4, 2)
    assert float(state["a.running_var"][0]) == 3.0
    with pytest.raises(ValueError):
        TM.params_from_jax({"['cache']['a']['x']": np.ones(1)})


def test_average_voxelization_bf16_sums_in_fp32(rng):
    P, C, D = 400, 6, 4
    values = rng.randn(P, C).astype(np.float32)
    points = rng.uniform(-0.5, D - 0.5, (P, 3)).astype(np.float32)
    batch = rng.randint(0, 2, P).astype(np.int32)
    kw = dict(batch_size=2, origin=(0.0, 0.0, 0.0), pitch=1.0, dimensions=D)
    v16 = torch.from_numpy(values).to(torch.bfloat16)
    got = TF.average_voxelization_3d(v16, torch.from_numpy(points),
                                     torch.from_numpy(batch), **kw)
    # the fp32 mean of the bf16 values, rounded once
    want = TF.average_voxelization_3d(v16.float(), torch.from_numpy(points),
                                      torch.from_numpy(batch), **kw)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)
    # JAX sums in bf16: within a few bf16 roundings of the same means
    jax_bf16 = np.asarray(JF.average_voxelization_3d(
        jnp.asarray(values, jnp.bfloat16), points, batch, **kw), np.float32)
    np.testing.assert_allclose(got.float().numpy(), jax_bf16, atol=0.05)


def test_interpolate_voxel_grid_bf16_matches_jax(rng):
    grid = rng.randn(2, 5, 5, 5, 3).astype(np.float32)
    points = rng.uniform(-0.5, 4.5, (50, 3)).astype(np.float32)
    batch = rng.randint(0, 2, 50).astype(np.int32)
    got = TF.interpolate_voxel_grid(
        torch.from_numpy(grid).to(torch.bfloat16), torch.from_numpy(points),
        torch.from_numpy(batch))
    want = JF.interpolate_voxel_grid(jnp.asarray(grid, jnp.bfloat16), points,
                                     batch)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.02)


def test_bf16_train_step_within_jax_bf16_gap(rng):
    """The train step's loss (ADD(-S) and the occupancy term) and gradients
    in bf16 (the tiny occupancy model, ``test_torch_train.py``'s batch and
    bank, dropout off, the same ``sample_indices``): the port's bf16 no
    farther from JAX's bf16 than JAX's bf16 is from JAX's fp32, for the
    loss and for the whole gradient (its norm over all parameters)."""
    from morefusion_tpu.models import losses as JL
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.training import trainer as TT
    from tests.test_torch_model import _flax_to_np
    from tests.test_torch_train import _batch, _jax_bank

    batch = _batch(rng)
    bank = TT.CadPointBank.build(ProceduralModels(), 21,
                                 max_solid_points=400, device="cpu")
    cfg = dict(n_point=32, with_occupancy=True)
    variables, _ = carried(lambda: TM.tiny_singleview3d(21, **cfg))
    tmodel = TM.tiny_singleview3d(21, compute_dtype=torch.bfloat16, **cfg)
    tmodel.load_state_dict(TM.variables_from_jax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    loss, _ = TT.make_loss_fn(tmodel, bank)(
        batch, True, train=False)
    loss.backward()
    tgrads = {k: p.grad for k, p in tmodel.named_parameters()}

    jbank = _jax_bank(bank)
    cid = batch["class_id"]
    inputs = {k: batch[k] for k in (
        "class_id", "rgb", "pcd", "pitch", "origin", "grid_nontarget_empty",
        "sample_indices")}

    def jloss(params, dtype):
        quat, trans, conf = JM.tiny_singleview3d(
            21, compute_dtype=dtype, **cfg).apply(params, **inputs)
        total = JL.pose_loss(
            quaternion_pred=quat, translation_pred=trans,
            confidence_pred=conf, quaternion_true=batch["quaternion_true"],
            translation_true=batch["translation_true"],
            cad_points=jbank.points[cid], symmetric=jbank.symmetric[cid])
        return total + JL.occupancy_loss(
                quaternion_pred=quat, translation_pred=trans,
                confidence_pred=conf, solid_points=jbank.solid_points[cid],
                solid_sdf=jbank.solid_sdf[cid],
                solid_mask=jbank.solid_mask[cid], pitch=batch["pitch"],
                origin=batch["origin"], grid_target=batch["grid_target"],
                grid_nontarget_empty=batch["grid_nontarget_empty"])

    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        value, grads = jax.jit(jax.value_and_grad(jloss), static_argnums=1)(
            variables, dt)
        out[dt] = float(value), TM.params_from_jax(_flax_to_np(grads))

    def flat(g):
        return torch.cat([g[k].reshape(-1).double() for k in sorted(g)])

    (l32, g32), (l16, g16) = out[jnp.float32], out[jnp.bfloat16]
    loss_gap, loss_err = abs(l16 - l32), abs(float(loss.detach()) - l16)
    grad_gap = float((flat(g16) - flat(g32)).norm())
    grad_err = float((flat(tgrads) - flat(g16)).norm())
    print(f"loss: gap {loss_gap} err {loss_err}; "
          f"gradient: gap {grad_gap} err {grad_err}")
    assert loss_gap > 0 and grad_gap > 0  # JAX's bf16 did compute in bf16
    assert loss_err <= loss_gap, (loss_err, loss_gap)
    assert grad_err <= grad_gap, (grad_err, grad_gap)
