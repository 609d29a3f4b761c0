"""On the card, at each cell's own size: the program's readings lie
within the cell's limits, and the control (the reference computed with
float8 operands in the program's place) and, for a train cell, half of
each batch left out of the loss, each fail at least one of them."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness.common import read_json
from benchmark.harness.judge import load_limits

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in read_json(os.path.join(
    ROOT, "BENCHMARK.json"))["workloads"]]


def _fails(numbers, limits):
    return [n for n, lim in limits.items()
            if n in numbers and not numbers[n][0] <= lim]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "benchmark/tools/control.py", "--workload", cell,
         "--seeds", "2147480001"], cwd=ROOT, capture_output=True, text=True,
        timeout=900, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    limits = load_limits(ROOT, cell)
    assert not _fails(got["program"], limits), got["program"]
    assert _fails(got["control_fp8"], limits), got["control_fp8"]
    if "half_batch" in got:
        assert _fails(got["half_batch"], limits), got["half_batch"]
