"""examples/marmousi_scale_torch.py on the CPU, mirroring
tests/test_examples.py's Marmousi smoke: at n_iters=6, nz=48, nx=64,
nt=280, 2 shots, npml=12, f0=18 the misfit and the in-anomaly vp error
both improve, and the per-iteration error is recorded.  Its misfit0 is
held to the JAX package's in tests/test_torch_example_misfits.py."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
from torch_threads import one_thread  # noqa: E402,F401  (autouse)


def test_marmousi_scale_smoke(tmp_path):
    from marmousi_scale_torch import main

    # f0=18: the full run's 6 Hz would put the anomalies far below the
    # lambda/2 resolution on this one-wavelength-sized grid
    m = main(outdir=str(tmp_path), n_iters=6, nz=48, nx=64, nt=280,
             n_shots=2, npml=12, f0=18.0, device="cpu")
    assert m["misfit1"] < 0.9 * m["misfit0"], m
    assert m["anom_err1"] < 0.95 * m["anom_err0"], m
    out = np.load(tmp_path / "marmousi_scale.npz")
    hist = out["anom_err_per_iter"]
    assert hist[-1] < hist[0]          # per-iteration recovery recorded
    assert m["n_evals"] >= m["nit"] == 6
