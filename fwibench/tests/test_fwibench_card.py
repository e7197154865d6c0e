"""On the card (marker `cuda`; skipped without one): a short run of each
cell through `fwibench/run.py`, correct and with its metrics.  Run with
`python -m pytest fwibench/tests -m cuda` on a machine with a card."""
import json
import subprocess
import sys

import pytest
import torch

from fwibench.tests.tiny import BENCH, ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(card, cell, trace):
    res = subprocess.run(
        [sys.executable, "fwibench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 41), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["metrics"]
