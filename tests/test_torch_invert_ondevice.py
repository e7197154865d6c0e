"""`invert --optimizer ondevice` of the port against the JAX package's
CLI, on the CPU: --optimizer ondevice --x64 --device cpu at
tests/test_cli.py's TINY against `sep2023_tpu.cli.main([... --optimizer
ondevice --x64 --engine xla])`, Results/loss.txt to 1e-6 and the model
snapshot to 1e-6 relative; the summary counts the on-device L-BFGS's
evaluations.  (--engine is in tests/test_torch_invert_engine.py.)
"""
import glob
import os

import numpy as np

from torch_invert_parity import hist, run_jax, run_port
from torch_threads import one_thread  # noqa: F401  (autouse)


def test_invert_ondevice_matches_jax_cli(tmp_path):
    ep, ej = str(tmp_path / "port"), str(tmp_path / "jax")
    flags = ["--optimizer", "ondevice"]
    out = run_port(ep, flags)
    run_jax(ej, [*flags, "--engine", "xla"])
    hp, hj = hist(ep), hist(ej)
    assert hp.shape == hj.shape == (2, 2)
    np.testing.assert_allclose(hp, hj, rtol=1e-6)
    assert hp[1, 1] < hp[0, 1]
    assert out["nit"] == 2 and out["n_evals"] > 2
    assert out["misfit"] == hp[-1, 1]
    snaps = sorted(os.path.basename(f) for f in
                   glob.glob(os.path.join(ep, "Results", "*.npz")))
    assert snaps == ["model_0002.npz"]
    with np.load(os.path.join(ep, "Results", snaps[0])) as zp, \
            np.load(os.path.join(ej, "Results", snaps[0])) as zj:
        assert sorted(zp.files) == sorted(zj.files) == ["rho", "vp", "vs"]
        for k in zj.files:
            np.testing.assert_allclose(zp[k], zj[k], rtol=1e-6)
