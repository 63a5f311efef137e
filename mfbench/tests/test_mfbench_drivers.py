"""Each cell's driver end to end at a tiny size on the CPU through the
test entry (``tiny.run_tiny``), and the command's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

from mfbench import harness
from mfbench.tests import tiny

CELLS = [w["name"] for w in harness.read_json(
    tiny.ROOT / "BENCHMARK.json")["workloads"]]
# every cell file, also those BENCHMARK.json does not list (yet)
FILES = sorted(p.stem for p in (tiny.ROOT / "mfbench" / "workloads").glob(
    "*.json"))


@pytest.mark.parametrize("name", FILES)
def test_cell_runs_tiny_on_the_cpu(name):
    result, checks = tiny.run_tiny(name, trace=False)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    cell = tiny.tiny_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {n for n, _, _ in checks} == set(cell.limits)


def test_every_listed_cell_has_its_file():
    assert set(CELLS) <= set(FILES)


@pytest.mark.parametrize("name", ["mf_occ.train.b16", "mf_occ.serve.pose8"])
def test_traced_run_reads_the_per_layer_metrics(name):
    result, _ = tiny.run_tiny(name, trace=True, seconds=1.0)
    assert result["correct"]
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # CPU runs have no device trace: only readers of the host's numbers
    assert "device.idle_pct.train" in result["metrics"] or \
        "device.idle_pct.serve" in result["metrics"]
    assert "busy_s" in result["device"]


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "mfbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
