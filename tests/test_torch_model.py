"""The port's SingleView3D against ``morefusion_tpu.models`` on the CPU.

Weights are carried across by ``params_from_jax`` and both forwards get the
same ``sample_indices`` (torch and jax.random draw different bits). fp32
on both sides: outputs agree to 1e-5 (convolution sums in another order).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from morefusion_tpu import models as JM
from morefusion_tpu.models import sampling as JS
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.models import sampling as TS
from morefusion_tpu_torch.models.pspnet import resize_bilinear

torch.set_num_threads(2)

RESULTS = Path(__file__).resolve().parent.parent / "docs/results"
CKPT = RESULTS / "occ_best_bf16.npz"


def _flax_to_np(variables):
    flat, _ = jax.tree_util.tree_flatten_with_path(variables)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def torch_to_flax(model):
    """A port model's weights as a flax variables tree (the inverse of
    ``params_from_jax``), so that tests need no slow flax ``init``."""
    tree = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        a = t.detach().numpy()
        if leaf == "weight":
            if "PReLU" in path[-1]:
                leaf, a = "negative_slope", a.reshape(())
            else:
                leaf = "kernel"
                a = a.T if a.ndim == 2 else a.transpose(
                    *range(2, a.ndim), 1, 0)
        node = tree.setdefault("params", {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree


def _inputs(rng, B, S, P, V=32):
    rgb = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    pcd = rng.uniform(-0.1, 0.1, (B, S, S, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    pcd[:, : S // 8] = np.nan
    mask = ~np.isnan(pcd).any(-1)
    idx = np.stack([
        rng.choice(np.flatnonzero(mask[b].ravel()), P, replace=False)
        for b in range(B)
    ]).astype(np.int32)
    return dict(
        class_id=(np.arange(B) % 5 + 1).astype(np.int32),
        rgb=rgb, pcd=pcd,
        pitch=rng.uniform(0.006, 0.012, B).astype(np.float32),
        grid_nontarget_empty=rng.rand(B, V, V, V).astype(np.float32),
        sample_indices=idx,
    )


def _compare(jmodel, make_tmodel, kw, atol):
    """Flax weights (from one randomly initialized port model) carried into
    another port model by ``params_from_jax``; both forwards compared."""
    torch.manual_seed(0)
    variables = torch_to_flax(make_tmodel())
    torch.manual_seed(1)
    tmodel = make_tmodel()
    tmodel.load_state_dict(TM.params_from_jax(_flax_to_np(variables)),
                           strict=True)
    tmodel.eval()
    jout = jax.jit(jmodel.apply)(variables, **kw)
    with torch.no_grad():
        tout = tmodel(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for j, t in zip(jout, tout):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, atol=atol)


@pytest.mark.parametrize("with_occupancy", [True, False])
def test_tiny_singleview3d_forward(rng, with_occupancy):
    # 80 px -> a 10 px backbone map: the 3-bin pyramid level is resized
    # 3 -> 10, a non-integer scale
    kw = _inputs(rng, B=2, S=80, P=32)
    if not with_occupancy:
        del kw["grid_nontarget_empty"]
    cfg = dict(n_point=32, with_occupancy=with_occupancy)
    _compare(JM.tiny_singleview3d(5, **cfg),
             lambda: TM.tiny_singleview3d(5, **cfg), kw, atol=1e-5)


@pytest.mark.parametrize("n,m", [(1, 32), (2, 32), (3, 32), (6, 32),
                                 (16, 32), (3, 10), (5, 7)])
def test_bilinear_resize_matches_jax_image_resize(rng, n, m):
    x = rng.rand(2, n, n, 4).astype(np.float32)
    want = jax.image.resize(x, (2, m, m, 4), "bilinear")
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), m, m)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)


def test_params_from_jax_inverts_the_flax_layout():
    torch.manual_seed(0)
    model = TM.tiny_singleview3d(4, with_occupancy=True)
    variables = torch_to_flax(model)
    # the flax model accepts the tree: same names and shapes as its init
    jmodel = JM.tiny_singleview3d(4, with_occupancy=True)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), class_id=np.ones(1, np.int32),
        rgb=np.zeros((1, 64, 64, 3), np.float32),
        pcd=np.ones((1, 64, 64, 3), np.float32),
        pitch=np.ones(1, np.float32),
        grid_nontarget_empty=np.zeros((1, 32, 32, 32), np.float32))
    assert (jax.tree_util.tree_map(np.shape, shapes)
            == jax.tree_util.tree_map(np.shape, variables))
    back = TM.params_from_jax(_flax_to_np(variables))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)


def test_masked_median_averages_the_middle_pair(rng):
    vals = rng.rand(4, 10, 3).astype(np.float32)
    mask = rng.rand(4, 10) > 0.5
    mask[0] = True  # even count
    mask[1] = False
    mask[1, :3] = True  # odd count
    mask[2] = False  # empty -> NaN
    got = TS.masked_median(torch.from_numpy(vals), torch.from_numpy(mask))
    want = np.asarray(JS.masked_median(vals, mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    assert np.isnan(got[2].numpy()).all()
    origin = TS.compute_origin(torch.from_numpy(vals[:, :, None, :]),
                               torch.from_numpy(mask[:, :, None]),
                               torch.full((4,), 0.01), 32)
    want = JS.compute_origin(vals[:, :, None, :], mask[:, :, None],
                             np.full((4,), 0.01, np.float32), 32)
    np.testing.assert_allclose(origin.numpy(), want, atol=1e-6)


def test_sample_mask_indices(rng):
    mask = np.zeros((3, 6, 7), bool)
    mask[0] = rng.rand(6, 7) > 0.3
    mask[1, 2, :3] = True  # fewer valid pixels than samples
    g = torch.Generator().manual_seed(0)
    idx = TS.sample_mask_indices(torch.from_numpy(mask), 10, g).numpy()
    assert idx.shape == (3, 10)
    flat = mask.reshape(3, -1)
    assert flat[0][idx[0]].all() and len(set(idx[0])) == 10
    assert sorted(set(idx[1])) == list(np.flatnonzero(flat[1]))
    assert flat[1][idx[1]].all()
    assert (idx[2] >= 0).all() and (idx[2] < 42).all()


def test_bf16_decode_matches_ml_dtypes(rng):
    x = rng.normal(size=1000).astype(np.float32) * 10.0 ** rng.randint(
        -20, 20, 1000)
    u16 = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    want = u16.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(TM.convert_jax.decode_bf16(u16), want)


def test_occ_checkpoint_loads_into_the_full_model():
    params = TM.load_jax_npz(CKPT)
    assert len(params) == 77
    assert sum(a.size for a in params.values()) == pytest.approx(30.9e6,
                                                                 rel=2e-3)
    model = TM.SingleView3D(n_fg_class=21, with_occupancy=True)
    model.load_state_dict(TM.params_from_jax(params), strict=True)
    out = params["['params']['heads']['conf_out']['bias']"]
    assert out.shape == (21,)


@pytest.mark.parametrize("name", ["occ", "noocc", "r5tex", "r5hires",
                                  "r5cont"])
def test_committed_checkpoint_loads_strict(name):
    """All five committed checkpoints: default widths, ``noocc`` without
    the occupancy branch."""
    model = TM.SingleView3D(n_fg_class=21, with_occupancy=name != "noocc")
    state = TM.params_from_jax(TM.load_jax_npz(
        RESULTS / f"{name}_best_bf16.npz"))
    model.load_state_dict(state, strict=True)
    assert all(torch.isfinite(v).all() for v in state.values())


@pytest.mark.slow
def test_full_width_checkpoint_forward_matches_jax(rng):
    """Run by hand: the committed occ checkpoint, full width, B=1."""
    params = TM.load_jax_npz(CKPT)
    kw = _inputs(rng, B=1, S=256, P=1000)
    jmodel = JM.SingleView3D(n_fg_class=21, with_occupancy=True)
    tree = {}
    for key, arr in params.items():
        node = tree
        *path, leaf = key[2:-2].split("']['")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    jout = jmodel.apply(tree, **kw)
    tmodel = TM.SingleView3D(n_fg_class=21, with_occupancy=True)
    tmodel.load_state_dict(TM.params_from_jax(params), strict=True)
    with torch.no_grad():
        tout = tmodel.eval()(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4)
