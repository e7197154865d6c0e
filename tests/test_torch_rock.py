"""The port's rock physics against the JAX package's, on the CPU, float64.

* Each function of rock_physics: its value and its gradient under a random
  cotangent equal sep2023_tpu.rock_physics's to 1e-12.
* The two rock heads' apply() and gradient, as test_torch_invert's
  test_head_matches_jax does for the other five.
* models.twin_experiment_setup for both rock heads and for the Main-005
  flow (a velocity head on the Gassmann model) equals the JAX package's.
* Typical sandstone PCS values give plausible velocities
  (tests/test_heads.py::test_rock_physics_ranges).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sep2023_tpu import heads as jheads
from sep2023_tpu import models as jmodels
from sep2023_tpu import rock_physics as jrp
from sep2023_tpu_torch import heads, models
from sep2023_tpu_torch import rock_physics as rp
from sep2023_tpu_torch.config import SimConfig

SHAPE = (6, 9)


def _f64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _pcs(rng):
    """Porosity, clay and saturation inside the rock heads' bounds."""
    return (rng.uniform(0.05, 0.4, SHAPE), rng.uniform(0.05, 0.6, SHAPE),
            rng.uniform(0.2, 1.0, SHAPE))


def _moduli(rng):
    phi = rng.uniform(0.05, 0.4, SHAPE)
    k_s = rng.uniform(25e9, 37e9, SHAPE)
    g_s = rng.uniform(15e9, 44e9, SHAPE)
    k_d = k_s * (1 - phi) / (1 + 20 * phi)
    return phi, k_s, g_s, k_d


# name -> (inputs from a generator, jax function, port function)
CASES = {
    "weighted_average": (
        lambda r: (r.uniform(1e3, 3e3, SHAPE), r.uniform(1e2, 1e3, SHAPE),
                   r.uniform(0, 1, SHAPE)),
        jrp.weighted_average, rp.weighted_average),
    "vrh VRH": (
        lambda r: (r.uniform(10e9, 40e9, SHAPE), r.uniform(10e9, 40e9, SHAPE),
                   r.uniform(0.05, 0.95, SHAPE)),
        jrp.vrh, rp.vrh),
    "vrh Voigt": (
        lambda r: (r.uniform(10e9, 40e9, SHAPE), r.uniform(10e9, 40e9, SHAPE),
                   r.uniform(0.05, 0.95, SHAPE)),
        lambda *a: jrp.vrh(*a, method="Voigt"),
        lambda *a: rp.vrh(*a, method="Voigt")),
    "vrh Reuss": (
        lambda r: (r.uniform(10e9, 40e9, SHAPE), r.uniform(10e9, 40e9, SHAPE),
                   r.uniform(0.05, 0.95, SHAPE)),
        lambda *a: jrp.vrh(*a, method="Reuss"),
        lambda *a: rp.vrh(*a, method="Reuss")),
    "pcs_to_lame_vrh": (_pcs, jrp.pcs_to_lame_vrh, rp.pcs_to_lame_vrh),
    "drained_moduli": (lambda r: _moduli(r)[:3], jrp.drained_moduli,
                       rp.drained_moduli),
    "biot_gassmann_ku": (
        lambda r: (lambda phi, k_s, g_s, k_d: (
            phi, r.uniform(0.04e9, 2.25e9, SHAPE), k_s, k_d))(*_moduli(r)),
        jrp.biot_gassmann_ku, rp.biot_gassmann_ku),
    "pcs_to_lame_gassmann": (_pcs, jrp.pcs_to_lame_gassmann,
                             rp.pcs_to_lame_gassmann),
    "pcs_to_lame_gassmann VRH": (
        _pcs, lambda *a: jrp.pcs_to_lame_gassmann(*a, method="VRH"),
        lambda *a: rp.pcs_to_lame_gassmann(*a, method="VRH")),
}


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), what


@pytest.mark.parametrize("name", list(CASES))
def test_rock_physics_matches_jax(name):
    make, jfn, tfn = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    inputs = make(rng)
    out_j, pull = jax.vjp(jfn, *(jnp.asarray(a) for a in inputs))
    single = not isinstance(out_j, tuple)
    outs_j = (out_j,) if single else out_j
    cts = [rng.standard_normal(SHAPE) for _ in outs_j]
    g_j = pull(jnp.asarray(cts[0]) if single
               else tuple(jnp.asarray(c) for c in cts))

    xs = [_f64(a).requires_grad_() for a in inputs]
    out_t = tfn(*xs)
    outs_t = (out_t,) if single else out_t
    g_t = torch.autograd.grad(outs_t, xs, [_f64(c) for c in cts])
    for a, b in zip(outs_t, outs_j):
        _close(a.detach().numpy(), b, f"{name} value")
    for i, (a, b) in enumerate(zip(g_t, g_j)):
        _close(a.numpy(), b, f"{name} gradient {i}")


@pytest.mark.parametrize("name", ["rock_vrh", "rock_gassmann"])
def test_rock_head_matches_jax(name):
    """apply() and its gradient under a random cotangent, float64, with the
    reference's blend mask and the twin experiment's initial model."""
    nz, nx, npml = 20, 30, 6
    grid = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0,
                     nt=10, dt=0.002, f0=10.0, npml=npml).grid
    _, init, bounds, names = models.twin_experiment_setup(name, nz, nx)
    rng = np.random.default_rng(8)
    params = {k: np.asarray(v) * (1 + 0.01 * rng.standard_normal(v.shape))
              for k, v in init.items()}
    cts = [rng.standard_normal(grid.shape) for _ in range(3)]

    jh = jheads.HEADS[name](grid, init, mask=jheads.default_mask(grid, 4),
                            bounds=bounds)
    out_j, pull = jax.vjp(jh.apply,
                          {k: jnp.asarray(v) for k, v in params.items()})
    (g_j,) = pull(tuple(jnp.asarray(c) for c in cts))

    th = heads.HEADS[name](grid, init, mask=heads.default_mask(grid, 4),
                           bounds=bounds)
    assert th.param_names == tuple(names) == jh.param_names == (
        "phi", "cc", "sw")
    tp = {k: _f64(v).requires_grad_() for k, v in params.items()}
    out_t = th.apply(tp)
    g_t = torch.autograd.grad(out_t, [tp[k] for k in names],
                              [_f64(c) for c in cts])
    for a, b in zip(out_t, out_j):
        _close(a.detach().numpy(), b, f"{name} apply")
    for k, g in zip(names, g_t):
        _close(g.numpy(), g_j[k], f"{name} gradient {k}")


@pytest.mark.parametrize("head,model", [("rock_vrh", "anomaly"),
                                        ("rock_gassmann", "anomaly"),
                                        ("vp_vs_rho", "rock")])
def test_twin_experiment_setup_matches_jax(head, model):
    t = models.twin_experiment_setup(head, 40, 64, model=model)
    j = jmodels.twin_experiment_setup(head, 40, 64, model=model)
    for dt_, dj in zip(t[:2], j[:2]):
        assert dt_.keys() == dj.keys()
        for k in dt_:
            np.testing.assert_allclose(dt_[k], dj[k], rtol=1e-14, atol=0)
    assert t[2].keys() == j[2].keys() and t[3] == j[3]
    for k in t[2]:
        np.testing.assert_allclose(t[2][k], j[2][k], rtol=1e-14)
    if model == "rock":
        # the Gassmann reservoir: a hydrocarbon lens, slower than its host
        vp = t[0]["vp"]
        assert vp[23, 32] < vp[23, 5] and np.isfinite(vp).all()


def test_rock_physics_ranges():
    """Typical sandstone PCS values give plausible velocities."""
    for fn in (rp.pcs_to_lame_vrh, rp.pcs_to_lame_gassmann):
        lam, mu, rho = fn(*(torch.tensor(v, dtype=torch.float64)
                            for v in (0.2, 0.3, 0.9)))
        vp = float(torch.sqrt((lam + 2 * mu) / rho))
        vs = float(torch.sqrt(mu / rho))
        assert 1500 < vp < 7000, (fn.__name__, vp)
        assert 800 < vs < 4500, (fn.__name__, vs)
        assert 1800 < float(rho) < 2800
