"""A later change adds a configuration, a cell and a per-layer metric as
new files and entries alone: the harness finds and runs them, and no file
that was there changes."""

import hashlib
import json
import shutil

import torch

from mfbench import harness
from mfbench.tests import tiny

NEW_METRIC = '''"""Steps of the window (a test's metric)."""


def read(run):
    return float(len(run.record.units)) or None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_alone_add_a_config_a_cell_and_a_metric(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "mfbench", root / "mfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)

    # the new files: a narrow PoseNet, its cell, a per-layer metric
    base = root / "mfbench"
    config = json.loads((base / "configs" / "posenet.json").read_text())
    config["name"] = "posenet_narrow"
    config["kwargs"].update(tiny.TINY_WIDTHS["PoseNet"])
    config["max_solid_points"] = 64
    (base / "configs" / "posenet_narrow.json").write_text(json.dumps(config))
    spec = json.loads((base / "workloads" / "posenet.train.b16.json")
                      .read_text())
    spec.update(config="posenet_narrow", traffic="train_b2")
    spec["params"].update({k: v for k, v in tiny.TINY_PARAMS.items()
                           if k in spec["params"]})
    (base / "workloads" / "posenet_narrow.train.b2.json").write_text(
        json.dumps(spec))
    (base / "layer_metrics" / "train.steps.py").write_text(NEW_METRIC)
    # ... and the entries that name them, appended to BENCHMARK.json
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "posenet_narrow", "source": config["source"],
        "file": "mfbench/configs/posenet_narrow.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "posenet_narrow.train.b2", "config": "posenet_narrow",
        "traffic": "train_b2", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("posenet_narrow.train.b2")
    bench["per_layer"].append({
        "name": "train.steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "train step",
        "moves": "train_crops_per_s",
        "workloads": ["posenet_narrow.train.b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    torch.set_num_threads(2)
    for trace in (False, True):
        result, checks = harness.execute(
            root, "posenet_narrow.train.b2", 5, 0.5, trace,
            torch.device("cpu"))
        assert result["correct"], checks
        key = "train.steps" if trace else "train_crops_per_s"
        assert result["metrics"][key]["value"] > 0
    after = _digests(root)
    changed = [p for p, d in before.items()
               if p != type(p)("BENCHMARK.json") and after.get(p) != d]
    assert changed == []
    # BENCHMARK.json kept every entry it had
    old = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for e in bench[key]}
        assert {e["name"] for e in old[key]} <= names
