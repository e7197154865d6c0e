"""Helpers of the benchmark's CPU tests: a cell's configuration cut to a
tiny size (the survey laid out as the port's `cli.benchmark_problem` lays
it out at that size), and one run of a cell on the CPU."""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "fwibench") not in sys.path:
    sys.path.insert(0, str(ROOT / "fwibench"))

import run as bench_run  # noqa: E402  fwibench/run.py

from fwibench.harness import work as wk  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str, nz=28, nx=48, nt=120, npml=8) -> dict:
    cj = wk.load("configs", name)
    cj.update(nz=nz, nx=nx, nt=nt, npml=npml,
              n_shots=len(range(10, nx - 10, 10)), n_rec=nx - 20,
              rec_z=min(int(round(95 * nz / 101)), nz - 6))
    return cj


def cell_config(cell: str) -> str:
    return next(w for w in BENCH["workloads"] if w["name"] == cell)["config"]


def run(cell: str, seed=2 ** 31 + 977, seconds=1.0, trace=False):
    """One run of `cell` on the CPU at the tiny size, against the cell's
    committed limits."""
    return bench_run.run_cell(BENCH, cell, seed, seconds, trace,
                              device="cpu", t_start=time.perf_counter(),
                              config=config(cell_config(cell)))
