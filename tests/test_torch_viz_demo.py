"""The port's drawings and demo against ``morefusion_tpu.extra.viz`` and
``examples/demo.py``.

- Each ``viz`` function of both packages on the same seeded arrays: uint8
  images identical, meshes and OBJ files identical; ``save_image`` read
  back, through imageio and through the cv2 writer the port uses where
  imageio is missing.
- ``cli.demo --tiny --device cpu`` beside ``examples/demo.py --tiny``: the
  port's model loaded from the JAX demo's own initial parameters through
  ``params_from_jax`` and fed JAX's pixel draw (both patched here, in
  neither package). The input and segmentation panes identical; the poses
  within the pipeline tolerance 1e-5 of ``test_torch_pipeline.py``, and
  the overlay pane the one JAX draws from the port's poses.
"""

import os
import runpy
import sys

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from morefusion_tpu import runtime as JR
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu.extra import viz as JV
from morefusion_tpu_torch import models as TM
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch.cli import demo
from morefusion_tpu_torch.datasets import ProceduralModels as TModels
from morefusion_tpu_torch.extra import viz as TV
from tests.test_torch_pipeline import _feed_jax_draw

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_ATOL = 1e-5  # test_torch_pipeline.py's pipeline tolerance


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.RandomState(0)
    label = rng.randint(-2, 15, (40, 50))
    rgb = rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    depth = rng.uniform(0.3, 1.2, (40, 50)).astype(np.float32)
    depth[rng.rand(40, 50) < 0.1] = np.nan
    grid = rng.rand(6, 5, 4)
    return dict(label=label, rgb=rgb, depth=depth, grid=grid)


def test_colorize_and_segmentation(arrays):
    for label in (arrays["label"], np.full((3, 4), -1)):
        want = JV.colorize_label(label)
        got = TV.colorize_label(label)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    for alpha in (0.5, 0.2, 1.0):
        np.testing.assert_array_equal(
            TV.draw_instance_segmentation(arrays["rgb"], arrays["label"],
                                          alpha),
            JV.draw_instance_segmentation(arrays["rgb"], arrays["label"],
                                          alpha))


def test_pose_overlay_and_tiles():
    K = np.array([[120.0, 0, 40], [0, 120, 30], [0, 0, 1]])
    Ts = []
    for k, t in enumerate([[0.0, 0.0, 0.5], [0.05, -0.03, 0.6]]):
        T = np.eye(4)
        T[:3, 3] = t
        Ts.append(T)
    rgb = np.random.RandomState(1).randint(0, 256, (60, 80, 3)).astype(
        np.uint8)
    want = JV.draw_pose_overlay(rgb, JModels(), [3, 14], Ts, K,
                                n_points_per_object=3000)
    got = TV.draw_pose_overlay(rgb, TModels(), [3, 14], Ts, K,
                               n_points_per_object=3000)
    np.testing.assert_array_equal(got, want)
    assert (got != rgb).any()
    for cols in (None, 2):
        imgs = [rgb, got, want]
        np.testing.assert_array_equal(TV.tile_images(imgs, cols),
                                      JV.tile_images(imgs, cols))


def test_voxel_mesh_and_obj(arrays, tmp_path):
    for threshold in (0.5, 0.9, 2.0):
        want = JV.voxel_grid_to_mesh(arrays["grid"], 0.01, [0.1, 0.2, 0.3],
                                     threshold)
        got = TV.voxel_grid_to_mesh(arrays["grid"], 0.01, [0.1, 0.2, 0.3],
                                    threshold)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    JV.save_obj(str(tmp_path / "j.obj"), *want)
    TV.save_obj(str(tmp_path / "t.obj"), *got)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()


def test_depth_to_rgb(arrays):
    depth = arrays["depth"]
    for kw in (dict(), dict(min_value=0.5, max_value=1.0)):
        np.testing.assert_array_equal(TV.depth_to_rgb(depth, **kw),
                                      JV.depth_to_rgb(depth, **kw))
    nan = np.full((3, 3), np.nan)
    np.testing.assert_array_equal(TV.depth_to_rgb(nan), JV.depth_to_rgb(nan))


@pytest.mark.parametrize("writer", ["imageio", "cv2"])
def test_save_image(arrays, tmp_path, monkeypatch, writer):
    grey = (arrays["label"] + 2).astype(np.uint8) * 10
    for name, img in (("rgb", arrays["rgb"]), ("grey", grey)):
        with monkeypatch.context() as m:
            if writer == "cv2":  # where imageio is not installed
                m.setitem(sys.modules, "imageio", None)
                m.setitem(sys.modules, "imageio.v2", None)
            assert TV.image_writer() == writer
            TV.save_image(str(tmp_path / f"t_{name}.png"), img)
        JV.save_image(str(tmp_path / f"j_{name}.png"), img)
        got = imageio.imread(str(tmp_path / f"t_{name}.png"))
        want = imageio.imread(str(tmp_path / f"j_{name}.png"))
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, want)


def _run_jax_demo(argv, monkeypatch):
    """``examples/demo.py`` as a script; returns its model's parameters
    and the frame's results."""
    seen = {}

    class Recorded(JR.ScenePipeline):
        def __init__(self, model, params, *args, **kw):
            seen["params"] = params
            super().__init__(model, params, *args, **kw)

        def process_frame(self, *args, **kw):
            seen["results"] = super().process_frame(*args, **kw)
            return seen["results"]

    monkeypatch.setattr(JR, "ScenePipeline", Recorded)
    monkeypatch.setattr(sys, "argv", ["demo.py"] + argv)
    runpy.run_path(os.path.join(ROOT, "examples", "demo.py"),
                   run_name="__main__")
    monkeypatch.undo()
    return seen


def test_demo_against_jax(tmp_path, monkeypatch):
    jax_png, port_png = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    seen = _run_jax_demo(["--tiny", "--out", jax_png], monkeypatch)
    flat, _ = jax.tree_util.tree_flatten_with_path(seen["params"])
    state = TM.params_from_jax(
        {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat})
    tiny = TM.tiny_singleview3d

    def loaded(n_fg_class, **kw):  # the JAX demo's initial parameters
        model = tiny(n_fg_class, **kw)
        model.load_state_dict(state)
        return model

    intrinsics = []

    class FedJaxDraw(TR.ScenePipeline):
        def __init__(self, model, *args, **kw):
            super().__init__(model, *args, **kw)
            _feed_jax_draw(self.pose_node, model.n_point)

        def process_frame(self, rgb, depth, K, *args, **kw):
            intrinsics.append(K)
            return super().process_frame(rgb, depth, K, *args, **kw)

    monkeypatch.setattr(TM, "tiny_singleview3d", loaded)
    monkeypatch.setattr(TR, "ScenePipeline", FedJaxDraw)
    results = demo.main(["--tiny", "--device", "cpu", "--out", port_png])
    want_results = seen["results"]
    assert sorted(results) == sorted(want_results) and results
    for i in results:
        assert results[i]["class_id"] == want_results[i]["class_id"]
        np.testing.assert_allclose(results[i]["T_cad2cam"],
                                   want_results[i]["T_cad2cam"],
                                   atol=POSE_ATOL)

    got, want = imageio.imread(port_png), imageio.imread(jax_png)
    assert got.shape == want.shape == (240, 960, 3)
    W = 320
    np.testing.assert_array_equal(got[:, :2 * W], want[:, :2 * W])
    # the overlay is JAX's drawing of the port's poses
    rgb = want[:, :W]
    np.testing.assert_array_equal(got[:, 2 * W:], JV.draw_pose_overlay(
        rgb, JModels(), [r["class_id"] for r in results.values()],
        [r["T_cad2cam"] for r in results.values()], intrinsics[0]))
    assert (got[:, 2 * W:] != rgb).any()

