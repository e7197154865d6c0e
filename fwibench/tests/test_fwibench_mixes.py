"""Both traffic mixes drive a tiny configuration on the CPU through the
port's plain versions, and the run comes out correct with its metrics."""
import math

import pytest
import torch

from fwibench.tests import tiny

CELLS = [w["name"] for w in tiny.BENCH["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell):
    res = tiny.run(cell, seconds=2.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e = [m["name"] for m in tiny.BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    # the device metrics have no reading on the CPU
    assert set(res["metrics"]) == set(e2e) - {"peak_mem_gib"}
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert res["device"]["platform"] == "cpu"


def test_invert_window_is_whole_evaluations():
    from fwibench.harness import readers
    res = tiny.run("main001-invert", seconds=0.5)
    assert res["attempted"] >= 1
    assert readers.window_s  # the window ends at an evaluation's end
    assert res["checks"]["x0_gap"]["value"] == 0.0
