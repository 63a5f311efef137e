"""The port's bilinear resize (``ops/resize.py``, ``csrc/resize.cu``)
against ``F.interpolate(mode="bilinear", align_corners=False)``.

On the CPU (``resize_bilinear`` is ``F.interpolate`` there):

- forward and gradient at PSPNet's seven shapes (the pyramid's 1, 2, 3 and
  6 up to 32^2, the x2 stages 32 -> 64 -> 128 -> 256) and the UNet's x2,
  at small B and C;
- the backward's gather in plain PyTorch, on the kernel's per-axis ranges
  and weights, against autograd through ``F.interpolate`` (float64 within
  1e-12; float32 within 1e-6 of the sum of the terms' magnitudes, the
  rounding of a sum taken in another order);
- the ranges are exactly the outputs that read each input, and the x2
  stencil's fixed table is the general rule at x2;
- under ``torch.profiler`` the counters read ``resize.calls`` = 7 a PSPNet
  forward and ``resize.kernel`` = 0;
- the card's route refuses a downsize, float16 and the rest; the CPU's
  takes them.

On the card (``-m cuda``; skips without one): the fp32 forward bit for bit
at the B = 16 shapes, the backward within 1e-6 of the float64 gradient (of
the terms' magnitudes) and of ``F.interpolate``'s (norm) and the same on
two runs, bf16 within bf16 rounding, other sizes (scales that are no
binary fractions, widths that are no multiple of 4, equal sizes, one axis
unchanged, an odd-width x2), and a PoseNet and a
SingleView3D train step against the same models on ``F.interpolate``.

This file imports no JAX, so that the card's tests run where there is
none: ``python -m pytest --noconftest tests/test_torch_resize.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch.models import pspnet
from morefusion_tpu_torch.models.segmentation import UNetSegmentation
from morefusion_tpu_torch.ops import resize as R
from morefusion_tpu_torch.training import trainer as TT
from morefusion_tpu_torch.utils import profiling

torch.set_num_threads(2)

# (H, W, h, w): PSPNet's pyramid and x2 stages at 256^2 crops, the UNet's x2
SHAPES = [(1, 1, 32, 32), (2, 2, 32, 32), (3, 3, 32, 32), (6, 6, 32, 32),
          (32, 32, 64, 64), (64, 64, 128, 128), (128, 128, 256, 256),
          (15, 20, 30, 40)]
IDS = [f"{H}x{W}-{h}x{w}" for H, W, h, w in SHAPES]
# the card's shapes at B = 16: (N, C, H, W, h, w)
CARD_SHAPES = [(16, 512, 1, 1, 32, 32), (16, 512, 2, 2, 32, 32),
               (16, 512, 3, 3, 32, 32), (16, 512, 6, 6, 32, 32),
               (16, 1024, 32, 32, 64, 64), (16, 256, 64, 64, 128, 128),
               (16, 64, 128, 128, 256, 256)]
CARD_IDS = [f"{C}x{H}-{h}" for _, C, H, _, h, _ in CARD_SHAPES]
# edges of the kernel's design: scales that are no binary fractions
# (rounding), widths that are no multiple of 4 (one output a thread; a small
# model's 80^2 crops resize its pyramid to 10^2, its 6-bin level 10^2 to
# 10^2: a copy), one axis equal and the other grown (general path), an x2 of
# odd width, 1-pixel axes
EDGE_SHAPES = [(2, 3, 5, 7, 11, 13), (2, 3, 4, 6, 8, 9), (2, 3, 6, 6, 10, 10),
               (2, 3, 10, 10, 10, 10), (2, 3, 5, 7, 11, 12),
               (2, 3, 4, 6, 4, 12), (2, 3, 15, 45, 30, 90),
               (2, 3, 1, 5, 2, 10), (2, 3, 3, 3, 8, 12), (2, 3, 7, 1, 14, 2)]


def _input(shape, dtype=torch.float32, seed=0, device="cpu"):
    g = np.random.RandomState(seed)
    return torch.from_numpy(g.standard_normal(shape)).to(device=device,
                                                         dtype=dtype)


def _autograd(fn, x, h, w, grad):
    x = x.detach().clone().requires_grad_(True)
    y = fn(x, h, w)
    y.backward(grad)
    return y.detach(), x.grad


def _abs_terms(grad, H, W):
    """float64 sum over each input element's terms of |weight x grad|
    (the weights are >= 0)."""
    return R.resize_bilinear_backward_plain(grad.abs().double(), H, W)


@pytest.mark.parametrize("H,W,h,w", SHAPES, ids=IDS)
def test_cpu_route_is_interpolate(H, W, h, w):
    x = _input((2, 3, H, W))
    grad = _input((2, 3, h, w), seed=1)
    y, gx = _autograd(R.resize_bilinear, x, h, w, grad)
    y_ref, gx_ref = _autograd(R.resize_bilinear_plain, x, h, w, grad)
    assert torch.equal(y, y_ref)
    assert torch.equal(gx, gx_ref)
    assert torch.equal(pspnet.resize_bilinear(x, h, w), y_ref)


@pytest.mark.parametrize("H,W,h,w", SHAPES, ids=IDS)
def test_backward_gather_equals_autograd(H, W, h, w):
    for dtype in (torch.float64, torch.float32):
        x = _input((2, 3, H, W), dtype)
        grad = _input((2, 3, h, w), dtype, seed=1)
        _, gx_ref = _autograd(R.resize_bilinear_plain, x, h, w, grad)
        gx = R.resize_bilinear_backward_plain(grad, H, W)
        assert gx.dtype == dtype and gx.shape == x.shape
        if dtype == torch.float64:
            scale = gx_ref.abs().max().item()
            assert (gx - gx_ref).abs().max().item() <= 1e-12 * scale
        else:
            bound = 1e-6 * _abs_terms(grad, H, W)
            assert ((gx.double() - gx_ref.double()).abs() <= bound).all()


@pytest.mark.parametrize("n_in,n_out", [
    (1, 32), (2, 32), (3, 32), (6, 32), (1, 2), (2, 4), (32, 64), (7, 14),
    (5, 11), (3, 8), (8, 8), (1, 1), (4, 5)])
def test_readers_are_the_outputs_that_read(n_in, n_out):
    i0, i1, l0, l1 = R.axis_taps(n_in, n_out)
    lo, hi = R.readers(n_in, n_out)
    weights = R.gather_weights(n_in, n_out)
    for i in range(n_in):
        reads = [o for o in range(n_out) if i0[o] == i or i1[o] == i]
        assert reads == list(range(lo[i], hi[i] + 1))
        want = np.zeros(n_out, np.float32)
        for o in reads:
            want[o] = ((l0[o] if i0[o] == i else np.float32(0))
                       + (l1[o] if i1[o] == i else np.float32(0)))
        np.testing.assert_array_equal(weights[i], want)


def test_x2_table_is_the_rule():
    for n in range(1, 65):
        np.testing.assert_array_equal(R.x2_weights(n),
                                      R.gather_weights(n, 2 * n))
    # the fixed taps: 1/4 and 3/4 inside, clamped at both edges
    np.testing.assert_array_equal(R.x2_weights(3), np.float32([
        [1, .75, .25, 0, 0, 0],
        [0, .25, .75, .75, .25, 0],
        [0, 0, 0, .25, .75, 1]]))


def _traced_counters(run):
    profiling.count("untraced")  # ends any earlier stretch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        run()
    return profiling.recorded()["counters"]


def test_counters_read_seven_calls_a_pspnet_forward():
    torch.manual_seed(0)
    net = pspnet.PSPNetExtractor(in_channels=8, out_channels=4,
                                 bottleneck_channels=16, up_channels=(8, 8, 8))
    x = _input((2, 8, 12, 12))
    with torch.no_grad():
        counters = _traced_counters(lambda: net(x))
    assert counters.get("resize.calls") == 7
    assert counters.get("resize.kernel", 0) == 0


def test_counters_read_the_unet_x2_stages():
    torch.manual_seed(0)
    net = UNetSegmentation(n_class=3, widths=(4, 8, 8))
    rgb = _input((1, 16, 24, 3)).abs() * 100
    with torch.no_grad():
        counters = _traced_counters(lambda: net(rgb))
    assert counters.get("resize.calls") == 2
    assert counters.get("resize.kernel", 0) == 0


@pytest.mark.parametrize("case", [
    "downsize_h", "downsize_w", "float16", "float64", "not_contiguous",
    "three_dims"])
def test_card_route_refuses(case):
    x = _input((2, 3, 8, 8))
    h, w = 16, 16
    if case == "downsize_h":
        h = 4
    elif case == "downsize_w":
        w = 7
    elif case in ("float16", "float64"):
        x = x.to(getattr(torch, case))
    elif case == "not_contiguous":
        x = x.transpose(2, 3)
    else:
        x = x[0]
    with pytest.raises(ValueError):
        R._check_kernel_args(x, h, w)
    if x.dim() == 4:
        # the CPU's route is F.interpolate, which takes them
        y = R.resize_bilinear(x, h, w)
        assert torch.equal(y, R.resize_bilinear_plain(x, h, w))


def test_no_kernel_for_other_devices():
    with pytest.raises(ValueError, match="device meta"):
        R.resize_bilinear(torch.empty((1, 1, 2, 2), device="meta"), 4, 4)


# --- on the card ---------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_backward_checks(x, h, w, grad):
    """The kernel's backward against float64 (terms' magnitudes), against
    F.interpolate's (norm), and on two runs."""
    H, W = x.shape[-2:]
    _, gx = _autograd(R.resize_bilinear, x, h, w, grad)
    _, gx_again = _autograd(R.resize_bilinear, x, h, w, grad)
    _, gx_lib = _autograd(R.resize_bilinear_plain, x, h, w, grad)
    assert torch.equal(gx, gx_again)
    _, gx64 = _autograd(R.resize_bilinear_plain, x.double(), h, w,
                        grad.double())
    bound = 1e-6 * _abs_terms(grad, H, W) + 1e-30
    assert ((gx.double() - gx64).abs() <= bound).all()
    gap = torch.linalg.vector_norm(gx - gx_lib) / torch.linalg.vector_norm(
        gx_lib)
    assert gap.item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
def test_card_fp32_forward_bit_identical_backward_close(shape):
    device = _card()
    N, C, H, W, h, w = shape
    x = _input((N, C, H, W), device=device)
    grad = _input((N, C, h, w), seed=1, device=device)
    before = R.resize_bilinear.launches
    y = R.resize_bilinear(x, h, w)
    assert R.resize_bilinear.launches == before + 1
    y_lib = R.resize_bilinear_plain(x, h, w)
    assert torch.equal(y.view(torch.int32), y_lib.view(torch.int32))
    _card_backward_checks(x, h, w, grad)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=[str(s[2:]) for s in EDGE_SHAPES])
def test_card_other_sizes(shape):
    device = _card()
    N, C, H, W, h, w = shape
    x = _input((N, C, H, W), device=device)
    grad = _input((N, C, h, w), seed=1, device=device)
    y = R.resize_bilinear(x, h, w)
    assert torch.equal(y.view(torch.int32),
                       R.resize_bilinear_plain(x, h, w).view(torch.int32))
    _card_backward_checks(x, h, w, grad)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
def test_card_bf16_within_bf16_rounding(shape):
    device = _card()
    N, C, H, W, h, w = shape
    x = _input((N, C, H, W), torch.bfloat16, device=device)
    grad = _input((N, C, h, w), torch.bfloat16, seed=1, device=device)
    y, gx = _autograd(R.resize_bilinear, x, h, w, grad)
    assert y.dtype == gx.dtype == torch.bfloat16
    y_lib = R.resize_bilinear_plain(x, h, w).float()
    ulp = 2.0 ** -8
    assert ((y.float() - y_lib).abs() <= ulp * y_lib.abs()).all()
    _, gx64 = _autograd(R.resize_bilinear_plain, x.double(), h, w,
                        grad.double())
    bound = ulp * gx64.abs() + 1e-5 * _abs_terms(grad, H, W)
    assert ((gx.double() - gx64).abs() <= bound).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_counts_every_call():
    device = _card()
    torch.manual_seed(0)
    net = pspnet.PSPNetExtractor(in_channels=16, out_channels=4,
                                 bottleneck_channels=32,
                                 up_channels=(16, 8, 8)).to(device)
    x = _input((2, 16, 32, 32), device=device)
    before = R.resize_bilinear.launches

    def run():
        net(x).sum().backward()

    counters = _traced_counters(run)
    assert counters.get("resize.calls") == 7
    assert counters.get("resize.kernel") == 7
    assert R.resize_bilinear.launches == before + 14


def _bank(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    n_class, n = 21, 256
    points = torch.rand((n_class + 1, 500, 3), generator=g) * 0.1 - 0.05
    points[0] = 0
    symmetric = torch.zeros(n_class + 1, dtype=torch.bool)
    symmetric[1::3] = True
    return TT.CadPointBank(
        points=points.to(device), symmetric=symmetric.to(device),
        solid_points=(torch.rand((n_class + 1, n, 3), generator=g) * 0.1
                      - 0.05).to(device),
        solid_sdf=(torch.rand((n_class + 1, n), generator=g)
                   * 0.01).to(device),
        solid_mask=(torch.rand((n_class + 1, n), generator=g)
                    < 0.8).to(device))


def _batch(B=2, S=256, V=32, seed=0):
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


# the benchmark's configurations (mfbench/configs/*.json): published widths
WIDTHS = dict(n_fg_class=21, n_point=1000, backbone_width=64,
              psp_bottleneck=1024, psp_up=(256, 64, 64),
              tower_widths=(640, 256, 128))


def _step(kind, device):
    """Loss and gradients of one train step of the full-width model at
    B = 2, 256^2 crops, from fixed weights."""
    torch.manual_seed(0)
    with torch.device(device):
        if kind == "singleview3d":
            model = TM.SingleView3D(
                voxel_dim=32, with_occupancy=True, conv3_channels=256,
                conv4_channels=512, point_widths=(64, 8, 128, 16), **WIDTHS)
        else:
            model = TM.PoseNet(centerize_pcd=True, **WIDTHS)
    state = TT.create_train_state(model)
    step = TT.make_train_step(model, _bank(device), augment=True)
    _, metrics = step(state, _batch(), True, seed=7)
    return (float(metrics["loss"]),
            {n: p.grad.double() for n, p in model.named_parameters()
             if p.grad is not None})


# mfbench's limits of the cells (workloads/*.json): loss and gradient
LIMITS = {"singleview3d": (3e-4, 1e-3), "posenet": (3e-5, 1.5e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["posenet", "singleview3d"])
def test_card_train_step_matches_interpolate(kind, monkeypatch):
    device = _card()
    loss, grads = _step(kind, device)
    monkeypatch.setattr(pspnet, "resize_bilinear", R.resize_bilinear_plain)
    loss_ref, grads_ref = _step(kind, device)
    loss_limit, grad_limit = LIMITS[kind]
    assert abs(loss - loss_ref) <= loss_limit * abs(loss_ref)
    norms = {n: torch.linalg.vector_norm(g).item()
             for n, g in grads_ref.items()}
    floor = float(np.median(list(norms.values())))
    worst = max(torch.linalg.vector_norm(grads[n] - g).item()
                / max(norms[n], floor) for n, g in grads_ref.items())
    assert worst <= grad_limit
