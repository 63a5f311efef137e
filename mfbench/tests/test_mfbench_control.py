"""On the card, at each cell's own size: the program passes the check,
and the control (the plain reference computed in TF32, put in the
program's place) fails it, on the seeds the control was read on. Run on a
machine with an NVIDIA GPU:

    python -m pytest mfbench/tests/test_mfbench_control.py -m cuda
"""

import pytest
import torch

from mfbench import calibrate, harness
from mfbench.tests import tiny

CELLS = [w["name"] for w in harness.read_json(
    tiny.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own size")
    limits = harness.load_cell(tiny.ROOT, name).limits
    line = calibrate.readings(tiny.ROOT, name, 11, 3.0, True,
                              torch.device("cuda", 0))
    assert all(v <= limits[n] for n, v in line["sound"].items()), line
    assert any(v > limits[n] for n, v in line["control_tf32"].items()), line
