"""Numerical-vs-analytical validation of the port's elastic propagator,
through examples/das_modeling_torch.solver_vs_analytic's problem (the
reference's 000-Solver-Benchmark.ipynb: a homogeneous 208x288 padded grid,
an explosive source, the 2D Aki & Richards line-source solution at 800 m
down and 1000 m across), run with snapshots every 25 steps on the CPU.
Mirrors tests/test_forward_analytic.py's three tests on the port, and holds
the printed vz correlation to the JAX example's to 1e-4.

As in the reference, the numerical VELOCITY is compared against the
analytic DISPLACEMENT (moment rate = Ricker), amplitudes normalized; the
solver injects +stf into (sxx, szz), the moment -M0 I in the
tension-positive analytic convention, hence the sign flip.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import das_modeling_torch as tdm  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)


def _corr(a, b):
    a = (a - a.mean()) / (a.std() + 1e-30)
    b = (b - b.mean()) / (b.std() + 1e-30)
    return float(np.mean(a * b))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tdm.solver_vs_analytic(str(tmp_path_factory.mktemp("dm")), "cpu")


def test_vx_vz_match_analytic(run):
    data, U = run["data"], run["analytic"]
    n = data.shape[-1]
    assert n == 676          # (700-1) // 25 * 25 + 1 samples
    cx = _corr(data[1, 0], -U[0][:n])
    cz = _corr(data[2, 0], -U[2][:n])
    assert cx > 0.98, f"vx correlation {cx}"
    assert cz > 0.98, f"vz correlation {cz}"
    assert run["snaps_vz"].shape == (27, 208, 288)


def test_pressure_kinematics(run):
    """P arrival time at the receiver matches r/vp + source delay."""
    pr = np.abs(run["data"][0, 0])
    r = np.hypot(1000.0, 800.0)
    t_arr = r / 4000.0 + 1.2 / 10.0
    assert abs(run["t"][pr.argmax()] - t_arr) < 0.05


def test_energy_absorbed_by_cpml(run):
    """Late-time coda must be tiny relative to the peak: CPML works."""
    vz = np.abs(run["data"][2, 0])
    assert vz[-50:].max() < 0.02 * vz.max()


def test_correlation_matches_jax_example(run, tmp_path, capsys):
    import das_modeling

    das_modeling.solver_vs_analytic(str(tmp_path))
    line = re.search(r"correlation: ([0-9.]+)", capsys.readouterr().out)
    assert abs(run["corr"] - float(line.group(1))) <= 1e-4
