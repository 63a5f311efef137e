"""Cells at a tiny size for the CPU tests: the files' cell with narrow
widths, small crops and grids and few points, run through
``harness.execute`` on the CPU."""

from __future__ import annotations

import copy
from pathlib import Path

import torch

from mfbench import harness

ROOT = Path(__file__).resolve().parents[2]

TINY_WIDTHS = {
    "SingleView3D": dict(n_point=32, voxel_dim=16, backbone_width=8,
                         psp_bottleneck=64, psp_up=[32, 16, 16],
                         conv3_channels=32, conv4_channels=64,
                         tower_widths=[64, 32, 16]),
    "PoseNet": dict(n_point=32, backbone_width=8, psp_bottleneck=64,
                    psp_up=[32, 16, 16], tower_widths=[64, 32, 16]),
}
TINY_PARAMS = dict(batch=2, image_size=32, voxel_dim=16, pool=3,
                   warmup_steps=1, trace_units=[1, 2], image_shape=[96, 128],
                   pool_frames=2, check_frames=2, max_points=64,
                   icc_iterations=4)


def file_cell(name: str, root: Path = ROOT) -> harness.Cell:
    """A cell from its files alone, for a cell file that ``BENCHMARK.json``
    does not list (yet): no metrics."""
    spec = harness.read_json(root / "mfbench" / "workloads" / f"{name}.json")
    bench = harness.read_json(root / "BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == spec["config"])
    entry = {k: spec[k] for k in ("config", "traffic", "chips", "why")}
    return harness.Cell(name=name, entry=dict(entry, name=name), spec=spec,
                        config=harness.read_json(root / config["file"]),
                        end_to_end=[], per_layer=[])


def tiny_cell(name: str, root: Path = ROOT) -> harness.Cell:
    try:
        cell = harness.load_cell(root, name)
    except KeyError:
        cell = file_cell(name, root)
    cell = copy.deepcopy(cell)
    cell.config["kwargs"].update(TINY_WIDTHS[cell.config["class"]])
    cell.config["max_solid_points"] = 64
    for k, v in TINY_PARAMS.items():
        if k in cell.spec["params"]:
            cell.spec["params"][k] = v
    return cell


def run_tiny(name: str, seed: int = 12345, seconds: float = 0.5,
             trace: bool = False, root: Path = ROOT):
    torch.set_num_threads(2)
    cell = tiny_cell(name, root)
    return harness.execute(root, name, seed, seconds, trace,
                           torch.device("cpu"), cell=cell)
