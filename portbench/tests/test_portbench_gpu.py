"""A whole run of a cell on the card, as the benchmark's command runs it:
marked ``gpu``, and skipped where no CUDA device is visible.

    python3 -m pytest portbench/tests -m gpu -p no:cacheprovider
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("trace", [0, 1])
def test_portbench_a_cell_runs_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "batch_scan.equal",
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert 0 < line["metrics"]["corr_roofline_pct.batch"]["value"] < 100
    else:
        assert line["metrics"]["pair_hours_per_s"]["value"] > 0
