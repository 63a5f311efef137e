"""The port runs where there is no JAX: it imports none of it.

``morefusion_tpu_torch`` and ``chip_smoke.py`` run on a machine without
jax, flax, optax or ml_dtypes, and importing anything of ``morefusion_tpu``
imports jax (``morefusion_tpu/__init__.py``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "morefusion_tpu")


def _port_sources():
    files = sorted((ROOT / "morefusion_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_sources_exist():
    files = _port_sources()
    assert all(f.exists() for f in files)
    assert len(files) > 10
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("runtime/pipeline.py", "runtime/fusion.py",
                   "runtime/tracking.py", "runtime/object_mapping.py",
                   "contrib/occupancy_mapping.py", "contrib/mapping_native.py",
                   "simulation/scene_generation.py", "extra/render.py",
                   "geometry/cameras.py", "geometry/trajectory.py",
                   "models/layers.py", "models/convert_torch.py",
                   "models/segmentation.py", "ops/connected_components.py",
                   "extra/image.py", "datasets/transform.py",
                   "datasets/packed.py",
                   "datasets/rgbd_pose_estimation/base.py",
                   "datasets/rgbd_pose_estimation/synthetic.py",
                   "datasets/rgbd_pose_estimation/augmentation.py",
                   "datasets/rgbd_pose_estimation/reindex.py",
                   "datasets/rgbd_pose_estimation/reindexed.py",
                   "training/augment_device.py", "training/data.py",
                   "training/evaluator.py", "training/reporting.py",
                   "training/checkpoints.py", "training/loop.py",
                   "cli/train.py", "cli/_eval.py", "cli/evaluate.py",
                   "cli/eval_sweep.py", "cli/ablation_report.py",
                   "cli/icc_diagnose.py", "cli/check_icp_vs_icc.py",
                   "models/posenet.py", "datasets/background_composite.py",
                   "datasets/instance_segmentation.py",
                   "cli/generate_data.py", "cli/train_segmentation.py",
                   "cli/pretrain_backbone.py", "functions/occupancy.py",
                   "contrib/occupancy_registration.py",
                   "datasets/external_results.py",
                   "datasets/rgbd_pose_estimation/frame_directory.py",
                   "runtime/replay.py", "utils/provenance.py",
                   "cli/align_occupancy_grids.py", "cli/replay_eval.py",
                   "cli/align_pointclouds.py", "cli/rescore_results.py",
                   "cli/stratify_results.py", "runtime/trajectory_exec.py",
                   "runtime/picking.py", "runtime/robot.py",
                   "runtime/planning_scene.py", "runtime/moveit_robot.py",
                   "runtime/ros_adapter.py", "extra/viz.py", "cli/demo.py",
                   "utils/timer.py", "utils/profiling.py",
                   "extra/meshio.py", "geometry/bbox.py",
                   "geometry/pointcloud.py", "geometry/voxel_mapping.py",
                   "datasets/ycb_video/models.py",
                   "datasets/ycb_video/dataset.py",
                   "cli/compute_voxel_size.py", "cli/visualize_data.py",
                   "cli/ambiguity_floor.py", "cli/profile_train.py",
                   "cli/profile_backward.py", "cli/export_checkpoint.py",
                   "cli/plot_curves.py", "cli/resolution_ab.py",
                   "cli/regen_datasets.py", "cli/campaign_guardian.py",
                   "parallel/__init__.py", "parallel/distributed.py",
                   "parallel/mesh.py", "training/transfer.py"):
        assert f"morefusion_tpu_torch/{module}" in names


# the card's machine is not known to have these (neither machine has ROS;
# matplotlib draws only plot_curves' PNG):
# the port imports them only inside the function that needs them
OPTIONAL = ("cv2", "sklearn", "imageio", "rospy", "cv_bridge",
            "message_filters", "tf", "geometry_msgs", "sensor_msgs",
            "matplotlib")


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_optional_import_at_module_level(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in top
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    bad = [m for m in names if m.split(".")[0] in OPTIONAL]
    assert not bad, f"{path} imports {bad} at module level"


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Import every module of the port in a process where importing any
    forbidden package fails."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "morefusion_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, importlib.abc, sys\n"
        f"FORBIDDEN = {FORBIDDEN!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in FORBIDDEN:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
