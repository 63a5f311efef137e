"""``cli.profile_train`` and ``cli.profile_backward`` on the CPU.

At a tiny size (the test-sized model with narrow point widths, B = 1 or 2,
32^2 or 48^2 crops, 200 solid points a class in the bank, one timed step):
every stage and variant runs and prints, the FLOP count is positive, and
the ablations do what they say. Variant B's interpolation gives the grid
no gradient and the points the same gradient as ``interpolate_voxel_grid``
(equal bit for bit: the same backward); variant C (and D) call no
nearest-neighbour search at all, while A does; every patch is undone
after the run. The batch is the JAX script's ``make_batch``, the same
draws.
"""

import os
import re
import runpy
from unittest import mock

import numpy as np
import pytest
import torch

from morefusion_tpu_torch import functions
from morefusion_tpu_torch.cli import profile_backward as pb
from morefusion_tpu_torch.cli import profile_train as pt
from morefusion_tpu_torch.functions import voxelization as vox
from morefusion_tpu_torch.models import singleview_3d as sv3d
from morefusion_tpu_torch.ops import knn
from morefusion_tpu_torch.training import trainer as TT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = (8, 4, 8, 4)


@pytest.fixture
def small(monkeypatch):
    """Narrow point widths (G and H keep theirs narrower still) and 200
    solid points a class; the build calls are recorded."""
    builds = []
    real_model, real_bank = pt.build_model, TT.CadPointBank.build

    def build_model(tiny, dtype, device, **kw):
        builds.append(dict(dtype=dtype, **kw))
        widths = (8, 4, 6, 2) if "point_widths" in kw else NARROW
        return real_model(tiny, dtype, device, point_widths=widths)

    monkeypatch.setattr(pt, "build_model", build_model)
    monkeypatch.setattr(TT.CadPointBank, "build",
                        lambda models, n, **kw: real_bank(
                            models, n, max_solid_points=200, **kw))
    return builds


def test_make_batch_is_the_scripts():
    want = runpy.run_path(os.path.join(ROOT, "examples",
                                       "profile_train.py"))["make_batch"](3)
    got = pt.make_batch(3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_profile_train_prints_every_stage(small, capsys, tmp_path):
    out = pt.main(["--tiny", "--device", "cpu", "--batch-size", "2",
                   "--steps", "1", "--image-size", "32",
                   "--trace-dir", str(tmp_path)])
    text = capsys.readouterr().out
    stages = ("train_step_fp32", "fwd_fp32", "train_step_bf16", "fwd_bf16",
              "backbone_fwd", "backbone_fwdbwd", "voxel_branch_fwd",
              "voxel_branch_fwdbwd", "towers_fwd", "add_loss_fwd")
    assert list(out["results"]) == list(stages)
    for stage in stages:
        assert re.search(rf"^{stage} +[0-9.]+ \(host", text, re.M), stage
        r = out["results"][stage]
        assert r["ms"] is None and r["host_ms"] > 0  # no CUDA events here
    assert out["step_flops"] > 0 and out["tflops_per_s"] > 0
    assert "TFLOP/s on cpu" in text
    assert sorted(out["first_call_s"]) == ["bf16", "fp32"]
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))
    assert [b["dtype"] for b in small] == [torch.float32, torch.bfloat16,
                                           torch.float32]


def test_profile_backward_variants_and_knn_calls(small, capsys):
    calls, marks = [], []
    real_nn = knn.nn_indices
    real_build = pt.build_model

    def counting_nn(*args, **kw):
        calls.append(1)
        return real_nn(*args, **kw)

    counting_nn.launches = 0  # the kernel's count: no launch on the CPU

    def marking_build(*args, **kw):
        marks.append(len(calls))
        return real_build(*args, **kw)

    with mock.patch.object(knn, "nn_indices", counting_nn), \
            mock.patch.object(pt, "build_model", marking_build):
        rows = pb.main(["--tiny", "--device", "cpu", "--batch-size", "1",
                        "--steps", "1", "--image-size", "32"])
    text = capsys.readouterr().out
    assert list(rows) == list("ABCDEFGH")
    for key, row in rows.items():
        assert re.search(rf"^{key} .* ms/step", text, re.M), key
        assert row["host_ms"] > 0 and row["flops"] > 0
        assert row["launches"]["steps"] == 4
    marks.append(len(calls))
    per_variant = dict(zip("ABCDEFGH", np.diff(marks)))
    assert per_variant["A"] > 0 and per_variant["B"] > 0
    assert per_variant["C"] == per_variant["D"] == 0
    for line in ("interp grid-VJP scatter", "ADD-S KNN fwd+bwd",
                 "sorted-VJP saving", "128ch-aligned bf16 delta"):
        assert line in text
    # the patches are undone
    assert sv3d.interpolate_voxel_grid is vox.interpolate_voxel_grid
    assert functions.average_distance_both is not pb.add_only
    assert ([b.get("point_widths") for b in small[-2:]]
            == [(64, 8, 96, 16)] * 2)


def test_align_only_runs_a_g_h(small):
    rows = pb.main(["--tiny", "--device", "cpu", "--batch-size", "1",
                    "--steps", "1", "--image-size", "32", "--align-only"])
    assert list(rows) == ["A", "G", "H"]


def test_no_grid_grad_interpolation():
    g = np.random.RandomState(0)
    grid = torch.tensor(g.rand(2, 5, 6, 4, 3), dtype=torch.float32)
    points = torch.tensor(g.uniform(-0.5, 5.5, (40, 3)), dtype=torch.float32)
    batch = torch.tensor(g.randint(0, 2, 40))
    w = torch.tensor(g.normal(size=(40, 3)), dtype=torch.float32)
    grads = {}
    for name, fn in (("plain", vox.interpolate_voxel_grid),
                     ("ablated", pb.interpolate_no_grid_grad)):
        gr = grid.clone().requires_grad_(True)
        p = points.clone().requires_grad_(True)
        out = fn(gr, p, batch)
        (out * w).sum().backward()
        grads[name] = (out.detach(), gr.grad, p.grad)
    torch.testing.assert_close(grads["ablated"][0], grads["plain"][0],
                               rtol=0, atol=0)
    assert grads["ablated"][1] is None  # no gradient reaches the grid
    assert grads["plain"][1].abs().sum() > 0
    torch.testing.assert_close(grads["ablated"][2], grads["plain"][2],
                               rtol=0, atol=0)


def test_add_only_is_add_twice():
    g = np.random.RandomState(1)
    pts = torch.tensor(g.normal(size=(2, 30, 3)), dtype=torch.float32)
    T = torch.eye(4).repeat(2, 1, 1)
    Tp = torch.eye(4).repeat(2, 3, 1, 1)
    Tp[..., :3, 3] = torch.tensor(g.normal(0, 0.01, (2, 3, 3)))
    add, add_s = pb.add_only(pts, T, Tp)
    assert add is add_s
    torch.testing.assert_close(add, functions.average_distance(pts, T, Tp),
                               rtol=0, atol=0)
