"""Shared by tests/test_torch_invert_*.py: `invert` of the port on the CPU
(--device cpu --x64) and `invert` of the JAX package on the same arguments,
the port held to the JAX package (first misfit of every stage to 1e-10,
Results/loss.txt to 1e-6).  Not a test module itself."""
import os

import numpy as np
import pytest

from sep2023_tpu import cli as jcli
from sep2023_tpu import optimize as joptimize
from sep2023_tpu_torch import cli, optimize

# tests/test_cli.py's tiny twin experiment: 3 shots, 28 receivers, 80 steps
TINY = ["--nz", "28", "--nx", "48", "--nt", "80", "--npml", "8",
        "--niter", "2", "--x64"]


def first_misfits(module, monkeypatch):
    """Record the misfit at the starting point of every lbfgsb call (one a
    stage)."""
    seen = []
    real = module.lbfgsb

    def spy(obj, *a, **k):
        seen.append(obj.fun(obj.x0))
        return real(obj, *a, **k)

    monkeypatch.setattr(module, "lbfgsb", spy)
    return seen


def hist(exp):
    """Results/loss.txt of an experiment: rows (iteration, misfit)."""
    return np.loadtxt(os.path.join(exp, "Results", "loss.txt"), ndmin=2)


def run_port(exp, flags):
    return cli.main(["invert", *TINY, "--device", "cpu", "--exp-name", exp,
                     *flags])


def run_jax(exp, flags):
    jcli.main(["invert", *TINY, "--n-devices", "1", "--exp-name", exp,
               *flags])


def run_both(tmp_path, monkeypatch, flags, port_flags=(), jax_flags=(),
             tag="run"):
    """Both packages' invert on TINY + flags (+ each one's own flags):
    every stage's first misfit to 1e-10 and loss.txt to 1e-6.  Returns
    (the port's summary, its experiment dir, the JAX one's, the first
    misfits)."""
    port_first = first_misfits(optimize, monkeypatch)
    jax_first = first_misfits(joptimize, monkeypatch)
    ep, ej = str(tmp_path / f"{tag}_port"), str(tmp_path / f"{tag}_jax")
    out = run_port(ep, [*flags, *port_flags])
    run_jax(ej, [*flags, *jax_flags])
    assert len(port_first) == len(jax_first) >= 1
    for a, b in zip(port_first, jax_first):
        assert a == pytest.approx(b, rel=1e-10, abs=0)
    hp, hj = hist(ep), hist(ej)
    assert hp.shape == hj.shape and len(hp) >= 1
    np.testing.assert_allclose(hp, hj, rtol=1e-6)
    return out, ep, ej, port_first
