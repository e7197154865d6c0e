"""optimize.lbfgs_on_device against the JAX package's (optax.lbfgs with its
zoom line search), on the CPU.

tests/test_optimize.py's quadratic, without and with bounds, float64: the
history equals JAX's to 1e-9 of its first value at every one of 40
iterations, the final parameters to 1e-8.  The FWI twin is in
tests/test_torch_lbfgs_twin.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sep2023_tpu import optimize as joptimize
from sep2023_tpu_torch import optimize
from torch_threads import one_thread  # noqa: F401  (autouse)

TARGET = np.array([[1.0, 2.0], [3.0, 4.0]])


def _jloss(p):
    return (jnp.sum((p["a"] - jnp.asarray(TARGET)) ** 2)
            + jnp.sum((p["b"] - 5.0) ** 2))


def _tloss(p):
    return (((p["a"] - torch.tensor(TARGET)) ** 2).sum()
            + ((p["b"] - 5.0) ** 2).sum())


@pytest.mark.parametrize("bounds", [None, {"a": (0.0, 2.5), "b": None}],
                         ids=["free", "bounded"])
def test_quadratic_matches_jax(bounds):
    p0 = {"a": np.zeros((2, 2)), "b": np.zeros(1)}
    pj, hj = joptimize.lbfgs_on_device(_jloss, p0, 40, bounds=bounds)
    pt, ht = optimize.lbfgs_on_device(_tloss, p0, 40, bounds=bounds,
                                      device="cpu", dtype=torch.float64)
    assert len(ht) == len(hj) == 40
    assert ht.n_evals >= 40
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-9 * hj[0])
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=0, atol=1e-8)
    if bounds:
        assert float(pt["a"].max()) <= 2.5
