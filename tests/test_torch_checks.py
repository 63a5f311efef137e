"""The port's headless checks (``morefusion_tpu_torch/checks``) beside the
JAX package's ``checks/*.py`` scripts on the CPU.

Each JAX script runs through ``runpy.run_path(..., run_name="__main__")``
(JAX on the CPU, as everywhere in these tests), its fixed
``/tmp/mftpu_checks`` paths redirected into the test's temporary directory
(``_jax_script``: the calls that make, test, write or read those paths map
the prefix, nothing else changes), and its artifacts are read back before
the port's check runs on the same seeds at ``--device cpu``. Where a script
keeps a number to itself (the rendered labels, the instances, the grids,
the ICP poses), a wrapper around the JAX function it calls records it.

Tolerances:
- scene views, the trajectory's path plot and views, the rendered labels,
  the instances and the browse tiles: bit-equal, and the printed lines
  equal; the browse pitch within 1e-7, the (matched, ground-truth,
  recovered) counts equal;
- augmentation: row 1 (the host augmentation, ``RandomState(0)``)
  bit-equal; row 2 is the device augmentation, whose draws differ by
  design (torch generators, not ``jax.random``): the port's check, with its
  draws replaced by JAX's parameters for ``PRNGKey(1..3)``, within
  ``255 * 1e-5`` of JAX's float output (as ``tests/test_torch_augment.py``
  holds the apply half), and its PNG within one grey level of JAX's;
- occupancy: the three grids within 1e-6, voxel counts and OBJ vertex
  counts equal, JAX's nearest-point search (``tdf._scan_core``, whose
  float32 expansion ``|c|^2 + |p|^2 - 2 c.p`` at voxel coordinates up to
  32 moves the grids by up to 5e-4) patched to the port's exact sum as
  ``tests/test_torch_train.py`` does;
- ICP: the ADD after each of the 60 iterations within 1e-5 m and the
  gated iteration count equal, JAX's float32 distance expansion patched to
  the exact sum as ``tests/test_torch_icp.py`` does (ROADMAP queue 3,
  "fp32 expansion").
"""

import contextlib
import io
import os
import runpy
import sys
from unittest import mock

import cv2
import jax
import numpy as np
import pytest
import torch

import morefusion_tpu.datasets as jdatasets
import morefusion_tpu.functions as jfunctions
import morefusion_tpu.models.segmentation as jseg
from morefusion_tpu.contrib import icp as jicp
from morefusion_tpu.extra import viz as jviz
from morefusion_tpu.functions import tdf as jtdf
from morefusion_tpu.runtime import fusion as jfusion
from morefusion_tpu.training import augment_device as JA
from morefusion_tpu_torch import checks as TC
from morefusion_tpu_torch.datasets import ProceduralModels
from morefusion_tpu_torch.checks import (
    check_augmentation,
    check_camera_trajectory,
    check_dataset_browse,
    check_icp_convergence,
    check_mapping_render,
    check_occupancy_voxelization,
    check_scene_generation,
    check_segmentation_instances,
)
from morefusion_tpu_torch.training import augment_device as TA
from tests.test_torch_train import _exact_scan_core

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_OUT = "/tmp/mftpu_checks"


def _mapped(fn, tmp):
    """``fn`` with a first argument under ``JAX_OUT`` moved into ``tmp``."""

    def call(path, *args, **kw):
        path = os.fspath(path)
        if path.startswith(JAX_OUT):
            path = str(tmp) + path[len(JAX_OUT):]
        return fn(path, *args, **kw)

    return call


def _jax_script(name, tmp, argv=(), patches=()):
    """``checks/<name>.py`` as ``__main__`` with its output under ``tmp``;
    returns its printed lines."""
    tmp.mkdir(exist_ok=True)
    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        for target, attr in ((os, "makedirs"), (os.path, "exists"),
                             (jviz, "save_image"), (jviz, "save_obj"),
                             (jdatasets, "reindex"),
                             (jdatasets,
                              "RGBDPoseEstimationDatasetReIndexed")):
            stack.enter_context(mock.patch.object(
                target, attr, _mapped(getattr(target, attr), tmp)))
        for p in patches:
            stack.enter_context(p)
        stack.enter_context(mock.patch.object(
            sys, "argv", [f"checks/{name}.py", *argv]))
        stack.enter_context(contextlib.redirect_stdout(out))
        runpy.run_path(os.path.join(REPO, "checks", f"{name}.py"),
                       run_name="__main__")
    return out.getvalue().splitlines()


def _port(module, tmp, argv=()):
    """The port's check at ``--device cpu`` into ``tmp`` -> (its result,
    its printed lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = module.main(["--device", "cpu", "--out-dir", str(tmp),
                           *argv])
    return res, out.getvalue().splitlines()


def _said(lines):
    """The printed lines but the paths written."""
    return [ln for ln in lines if not ln.startswith("wrote")]


def _png(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


def _recorder(fn, into):
    def call(*args, **kw):
        out = fn(*args, **kw)
        into.append(out)
        return out

    return call


def test_checks_are_the_eight_scripts():
    scripts = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "checks"))
                     if f.endswith(".py"))
    assert sorted(TC.CHECKS) == scripts


def test_scene_generation_matches_jax(tmp_path):
    said = _jax_script("check_scene_generation", tmp_path / "jax")
    res, got = _port(check_scene_generation, tmp_path / "port")
    assert _said(got) == _said(said) == ["placed 5 objects"]
    want = _png(tmp_path / "jax" / "scene_views.png")
    np.testing.assert_array_equal(_png(tmp_path / "port" / "scene_views.png"),
                                  want)
    assert res["image"].shape == want.shape


def test_camera_trajectory_matches_jax(tmp_path):
    said = _jax_script("check_camera_trajectory", tmp_path / "jax")
    res, got = _port(check_camera_trajectory, tmp_path / "port")
    assert _said(got) == _said(said) and len(_said(got)) == 2
    for name in ("trajectory_path.png", "trajectory_views.png"):
        np.testing.assert_array_equal(_png(tmp_path / "port" / name),
                                      _png(tmp_path / "jax" / name))
    assert res["eyes"].shape == (5, 3)


def test_mapping_render_matches_jax(tmp_path):
    labels = []
    real = jfusion.OccupancyFusion.render_labels

    def render(self, *args):
        out = real(self, *args)
        labels.append(out[0])
        return out

    said = _jax_script("check_mapping_render", tmp_path / "jax", patches=[
        mock.patch.object(jfusion.OccupancyFusion, "render_labels", render)])
    res, got = _port(check_mapping_render, tmp_path / "port")
    assert _said(got) == _said(said)
    assert len(labels) == 1
    np.testing.assert_array_equal(res["label"], labels[0])
    np.testing.assert_array_equal(_png(tmp_path / "port" /
                                       "mapping_render.png"),
                                  _png(tmp_path / "jax" /
                                       "mapping_render.png"))
    assert res["agreement"] > 0.9


def test_segmentation_instances_match_jax(tmp_path):
    instances, matches = [], []
    said = _jax_script(
        "check_segmentation_instances", tmp_path / "jax", patches=[
            mock.patch.object(jseg, "instances_from_predictions", _recorder(
                jseg.instances_from_predictions, instances)),
            mock.patch.object(jseg, "match_instances", _recorder(
                jseg.match_instances, matches))])
    res, got = _port(check_segmentation_instances, tmp_path / "port")
    assert _said(got)[0] == _said(said)[0]
    (label, classes), = instances
    np.testing.assert_array_equal(res["label"], label)
    assert res["classes"] == classes
    assert res["counts"] == matches[0]
    np.testing.assert_array_equal(
        _png(tmp_path / "port" / "segmentation_instances.png"),
        _png(tmp_path / "jax" / "segmentation_instances.png"))
    # the device instancing on the CPU: the same ground truth, an instance
    # count of its own (no distance-transform reassignment)
    assert res["device_counts"][1] == res["counts"][1]
    assert res["device_counts"][0] > 0


def test_dataset_browse_matches_jax(tmp_path):
    pitches = []
    real = jdatasets.RGBDPoseEstimationDatasetReIndexed.get_example

    def get_example(self, i):
        ex = real(self, i)
        pitches.append(float(ex["pitch"]))
        return ex

    said = _jax_script("check_dataset_browse", tmp_path / "jax", patches=[
        mock.patch.object(jdatasets.RGBDPoseEstimationDatasetReIndexed,
                          "get_example", get_example)])
    want = _png(tmp_path / "jax" / "dataset_browse.png")
    res, got = _port(check_dataset_browse, tmp_path / "port")
    assert _said(got) == _said(said)
    np.testing.assert_array_equal(
        _png(tmp_path / "port" / "dataset_browse.png"), want)
    np.testing.assert_allclose(res["pitches"], pitches, rtol=0, atol=1e-7)
    # the port reading JAX's reindexed set (--data)
    res, _ = _port(check_dataset_browse, tmp_path / "port_data",
                   ["--data", str(tmp_path / "jax" / "browse_data")])
    np.testing.assert_array_equal(
        _png(tmp_path / "port_data" / "dataset_browse.png"), want)


def _jax_rgb_draws(s):
    """The parameters JAX's ``augment_rgb_device`` draws from
    ``PRNGKey(s)`` for one image, as the port's ``draw_rgb_params``
    returns them."""
    k_con, k_h, k_s, k_v, k_sig, k_sc = jax.random.split(
        jax.random.PRNGKey(s), 6)

    def uniform(key, lo, hi):
        return torch.tensor(np.asarray(jax.random.uniform(
            key, (1,), minval=lo, maxval=hi)), dtype=torch.float32)

    sigma = uniform(k_sig, 0.0, 1.0)
    return dict(alpha=uniform(k_con, 0.8, 1.2), fh=uniform(k_h, 0.95, 1.05),
                fs=uniform(k_s, 0.8, 1.2), fv=uniform(k_v, 0.8, 1.2),
                sigma=torch.where(sigma < 0.1, torch.full_like(sigma, 1e-3),
                                  sigma),
                scale_idx=torch.tensor(np.asarray(jax.random.randint(
                    k_sc, (1,), 0, len(JA._SCALES)))))


def test_augmentation_matches_jax(tmp_path):
    _jax_script("check_augmentation", tmp_path / "jax")
    want = _png(tmp_path / "jax" / "augmentation.png")
    draws = iter([_jax_rgb_draws(s) for s in range(1, 4)])
    with mock.patch.object(TA, "draw_rgb_params",
                           lambda *args: next(draws)):
        res, _ = _port(check_augmentation, tmp_path / "port")
    got = _png(tmp_path / "port" / "augmentation.png")
    assert got.shape == want.shape
    half = got.shape[0] // 2
    np.testing.assert_array_equal(got[:half], want[:half])
    rgb = res["row1"][0]
    aug = jax.jit(JA.augment_rgb_device)
    for s, row in enumerate(res["row2_float"], start=1):
        jax_row = np.asarray(aug(jax.random.PRNGKey(s),
                                 rgb[None].astype(np.float32)))[0]
        np.testing.assert_allclose(row, jax_row, rtol=0, atol=255 * 1e-5)
    assert np.abs(got[half:].astype(int) - want[half:]).max() <= 1


def _obj_vertices(path):
    with open(path) as f:
        return sum(1 for ln in f if ln.startswith("v "))


def test_occupancy_voxelization_matches_jax(tmp_path):
    grids = []
    said = _jax_script(
        "check_occupancy_voxelization", tmp_path / "jax", patches=[
            mock.patch.object(jtdf, "_scan_core", _exact_scan_core),
            mock.patch.object(jfunctions, "pseudo_occupancy_voxelization",
                              _recorder(
                                  jfunctions.pseudo_occupancy_voxelization,
                                  grids))])
    res, got = _port(check_occupancy_voxelization, tmp_path / "port")
    (want,) = grids
    for name, g in zip(check_occupancy_voxelization.NAMES, want):
        np.testing.assert_allclose(res["grids"][name], np.asarray(g),
                                   rtol=0, atol=1e-6)
        assert res["voxels"][name] == int((np.asarray(g) > 0.5).sum())
        assert res["vertices"][name] == _obj_vertices(
            tmp_path / "jax" / f"occupancy_{name}.obj") == _obj_vertices(
            tmp_path / "port" / f"occupancy_{name}.obj")
    assert [ln.split(" -> ")[0] for ln in got] == [
        ln.split(" -> ")[0] for ln in said]


def _exact_pairwise(a, b):
    d = a[:, None, :] - b[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def test_icp_convergence_matches_jax(tmp_path):
    poses, gated = [], []
    real_iterative = jicp.ICPRegistration.register_iterative
    real_register = jicp.ICPRegistration.register

    def register_iterative(self, *args, **kw):
        for T in real_iterative(self, *args, **kw):
            poses.append(np.array(T))
            yield T

    def register(self, *args, **kw):
        out = real_register(self, *args, **kw)
        gated.append(int(self.last_n_iterations))
        return out

    jax.clear_caches()  # JAX's search traced afresh with the exact sum
    try:
        said = _jax_script("check_icp_convergence", tmp_path / "jax",
                           patches=[
            mock.patch.object(jicp, "pairwise_sq_dist", _exact_pairwise),
            mock.patch.object(jicp.ICPRegistration, "register_iterative",
                              register_iterative),
            mock.patch.object(jicp.ICPRegistration, "register", register)])
    finally:
        jax.clear_caches()
    res, got = _port(check_icp_convergence, tmp_path / "port")
    # the script's scene: class 2's CAD points 0.5 m in front
    cad = ProceduralModels().get_pcd(2).astype(np.float32)
    depth = cad @ np.eye(3).T + np.array([0, 0, 0.5])
    want = [np.linalg.norm((cad @ T[:3, :3].T + T[:3, 3]) - depth,
                           axis=1).mean() for T in poses]
    assert len(res["add"]) == len(want) == 61
    np.testing.assert_allclose(res["add"], want, rtol=0, atol=1e-5)
    assert res["n_gated"] == gated[0]
    assert said[0].split(";")[1] == got[0].split(";")[1]
    assert os.path.exists(tmp_path / "port" / "icp_convergence.png")
