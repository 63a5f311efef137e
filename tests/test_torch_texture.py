"""The port's texture path and data CLI against ``morefusion_tpu``.

All bit for bit on the CPU:
- ``ProceduralModels(textured=True).get_point_colors`` for all 21 classes
  on their surface samples;
- a textured ``render_scene`` frame, and a textured
  ``SyntheticRGBDPoseEstimationDataset`` frame; the textured and the
  untextured frame of one seed differ in ``rgb`` only;
- ``cli.generate_data`` against ``examples/synthetic/generate_data.py``
  run through ``runpy`` (2 frames, ``--textured``, both settle modes, small
  frames): ``meta.json`` equal and every npz equal array for array.
"""

import json
import os
import runpy
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from morefusion_tpu import datasets as JD
from morefusion_tpu.extra import render as jrender
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch.cli import generate_data as cli
from morefusion_tpu_torch.extra import render as trender

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "synthetic", "generate_data.py")
SHAPE = (96, 128)


def _equal(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, key
    np.testing.assert_array_equal(a, b, err_msg=key)


def test_point_colors_match_jax_for_every_class():
    jm = JD.ProceduralModels(textured=True)
    tm = TD.ProceduralModels(textured=True)
    assert tm.textured and not TD.ProceduralModels().textured
    n_label = 0
    for cid in range(1, 22):
        pts, _ = tm.get_surface_samples(cid, 3000)
        got = tm.get_point_colors(cid, pts)
        assert got.dtype == np.uint8 and got.shape == (len(pts), 3)
        _equal(got, jm.get_point_colors(cid, pts), cid)
        # the label patch in the complementary colour
        n_label += int((got == 255 - tm.get_color(cid)).all(axis=1).sum())
    assert n_label > 0


def test_textured_render_scene_matches_jax():
    K = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]])
    Ts = []
    for dx in (-0.08, 0.08):
        T = np.eye(4)
        T[:3, 3] = [dx, 0.0, 0.6]
        Ts.append(T)
    kw = dict(class_ids=[2, 14], Ts_cad2cam=Ts, K=K, shape=SHAPE,
              n_points_per_object=5000)
    got = trender.render_scene(TD.ProceduralModels(textured=True), **kw)
    want = jrender.render_scene(JD.ProceduralModels(textured=True), **kw)
    for k in want:
        _equal(got[k], want[k], k)
    flat = trender.render_scene(TD.ProceduralModels(), **kw)
    assert not np.array_equal(got["rgb"], flat["rgb"])
    for k in ("depth", "instance_label"):
        _equal(got[k], flat[k], k)


def test_textured_dataset_frame_matches_jax_and_differs_in_rgb_only():
    kw = dict(n_frames=2, n_objects=(2, 3), image_shape=SHAPE)
    tex = TD.SyntheticRGBDPoseEstimationDataset(
        models=TD.ProceduralModels(textured=True), **kw).get_frame(1)
    want = JD.SyntheticRGBDPoseEstimationDataset(
        models=JD.ProceduralModels(textured=True), **kw).get_frame(1)
    flat = TD.SyntheticRGBDPoseEstimationDataset(**kw).get_frame(1)
    assert sorted(tex) == sorted(want) == sorted(flat)
    for k in want:
        _equal(tex[k], want[k], k)
        if k != "rgb":
            _equal(tex[k], flat[k], k)
    assert not np.array_equal(tex["rgb"], flat["rgb"])


def _read_set(root):
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    arrays = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".npz"):
                path = os.path.join(dirpath, name)
                with np.load(path) as data:
                    arrays[os.path.relpath(path, root)] = {
                        k: data[k] for k in data.files}
    return meta, arrays


@pytest.mark.parametrize("settle", ["physics", "drop"])
def test_generate_data_cli_matches_jax_script(tmp_path, settle):
    flags = ["--split", "val", "--n-frames", "2", "--n-objects", "2", "3",
             "--image-shape", str(SHAPE[0]), str(SHAPE[1]), "--seed", "3",
             "--settle", settle, "--textured"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    with mock.patch.object(sys, "argv",
                           ["generate_data.py", "--out", jax_out] + flags):
        runpy.run_path(SCRIPT, run_name="__main__")
    meta = cli.main(["--out", port_out] + flags)
    want_meta, want = _read_set(jax_out)
    got_meta, got = _read_set(port_out)
    assert got_meta == want_meta and len(meta) == len(want_meta) > 0
    assert sorted(got) == sorted(want)
    for name, arrays in want.items():
        assert sorted(got[name]) == sorted(arrays), name
        for k, v in arrays.items():
            _equal(got[name][k], v, f"{name}:{k}")
