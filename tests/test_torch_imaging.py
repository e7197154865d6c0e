"""The port's imaging utilities against the JAX package's
(sep2023_tpu/imaging.py), float64, on the same numpy inputs made from a
seed.

* `lame_grads_to_velocity`: 1e-12 of each output's max.
* `rtm_image`: a zero residual gives a zero image; against the JAX
  `imaging.rtm_image` 1e-10 of the image's max, and equal to the Vp chain
  rule of the Lame gradients of the same misfit (1e-10).
* `source_illumination`: 1e-12 of its max, shot by shot.
* `illumination_compensate`, `normalize_image`: 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu import imaging as jim
from sep2023_tpu import parallel as jpar
from sep2023_tpu.config import Survey
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import convert, imaging, propagator
from sep2023_tpu_torch.ops import misfit as tmf

NPML = 8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def problem():
    """A 30x44 grid (npml 8), 2 shots, a receiver row 12 rows under them,
    nt=110; numpy (vp, vs, rho), wavelets and both packages' geometries."""
    kw = dict(nz=30 + 2 * NPML, nx=44 + 2 * NPML, dz=20.0, dx=20.0, nt=110,
              dt=0.002, f0=10.0, npml=NPML)
    jcfg, cfg = st.SimConfig(**kw), tcfg.SimConfig(**kw)
    rng = np.random.default_rng(9)
    shape = (cfg.nz, cfg.nx)
    vp = 3000.0 + 40.0 * rng.standard_normal(shape)
    vp[NPML + 16:NPML + 22, NPML + 14:NPML + 30] += 300.0
    vs = vp / np.sqrt(2.2)
    rho = 2400.0 + 10.0 * rng.standard_normal(shape)
    survey = Survey(src_z=np.array([2, 2]), src_x=np.array([10, 30]),
                    rec_z=np.full(28, 14), rec_x=np.arange(8, 36),
                    src_rxz=np.array([1.0, 1.4]))
    stf = np.stack([st.ricker(10.0, 110, 0.002),
                    0.5 * st.ricker(12.0, 110, 0.002)])
    jgeoms = jpar.survey_to_geoms(survey, NPML, dtype=jnp.float64)
    lam, mu = (vp ** 2 - 2 * vs ** 2) * rho, vs ** 2 * rho
    args = convert.params_from_numpy(lam, mu, rho, stf, jgeoms, device="cpu",
                                     dtype=torch.float64)
    return jcfg, cfg, (vp, vs, rho), stf, jgeoms, args


def test_lame_grads_to_velocity_matches_jax():
    rng = np.random.default_rng(1)
    a = [rng.standard_normal((12, 17)) for _ in range(3)]
    m = [3000.0 + rng.standard_normal((12, 17)),
         1700.0 + rng.standard_normal((12, 17)),
         2400.0 + rng.standard_normal((12, 17))]
    ref = jim.lame_grads_to_velocity(*(jnp.asarray(x) for x in (*a, *m)))
    out = imaging.lame_grads_to_velocity(*(_t(x) for x in (*a, *m)))
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-12


def test_rtm_image_matches_jax(problem):
    jcfg, cfg, (vp, vs, rho), stf, jgeoms, args = problem
    lam, mu, rho_t, stf_t, geoms = args
    one = lambda g, i: type(g)(*(None if a is None else a[i] for a in g))
    obs = propagator.propagate_shots(cfg, lam * 1.04, mu, rho_t, stf_t,
                                     geoms)
    ch = ("pr", "vx", "vz")
    img = imaging.rtm_image(cfg, _t(vp), _t(vs), rho_t, stf_t[1],
                            one(geoms, 1), obs[1], channels=ch)
    ref = jim.rtm_image(jcfg, jnp.asarray(vp), jnp.asarray(vs),
                        jnp.asarray(rho), jnp.asarray(stf[1]),
                        one(jgeoms, 1), jnp.asarray(obs[1].numpy()),
                        channels=ch)
    assert np.abs(np.asarray(ref)).max() > 0
    assert _rel(img.numpy(), ref) < 1e-10

    # the image is the Vp chain rule of the Lame gradients of that misfit
    ps_ = [a.clone().requires_grad_() for a in (lam, mu, rho_t)]
    syn = propagator.propagate(cfg, *ps_, stf_t[1], one(geoms, 1))
    g = torch.autograd.grad(tmf.l2_misfit(obs[1], syn, channels=ch), ps_)
    g_vp, _, _ = imaging.lame_grads_to_velocity(*g, _t(vp), _t(vs), rho_t)
    assert _rel(img.numpy(), g_vp.numpy()) < 1e-10

    # a zero residual (the data of the model itself) images nothing
    same = propagator.propagate(cfg, lam, mu, rho_t, stf_t[0], one(geoms, 0))
    zero = imaging.rtm_image(cfg, _t(vp), _t(vs), rho_t, stf_t[0],
                             one(geoms, 0), same, channels=ch)
    assert float(zero.abs().max()) == 0.0


def test_source_illumination_matches_jax(problem):
    jcfg, cfg, (vp, vs, rho), stf, jgeoms, args = problem
    lam, mu, rho_t, stf_t, geoms = args
    ill = imaging.source_illumination(cfg, lam, mu, rho_t, stf_t, geoms)
    assert ill.shape == (2, cfg.nz, cfg.nx)
    assert float(ill.min()) >= 0 and float(ill[:, :NPML].max()) == 0
    for i in range(2):
        g = type(jgeoms)(*(None if a is None else a[i] for a in jgeoms))
        ref = jim.source_illumination(
            jcfg, jnp.asarray(lam.numpy()), jnp.asarray(mu.numpy()),
            jnp.asarray(rho), jnp.asarray(stf[i]), g)
        assert np.asarray(ref).max() > 0
        assert _rel(ill[i].numpy(), ref) < 1e-12


def test_compensate_and_normalize_match_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((20, 31))
    ill = rng.random((20, 31)) ** 4
    assert _rel(imaging.illumination_compensate(_t(img), _t(ill)).numpy(),
                jim.illumination_compensate(jnp.asarray(img),
                                            jnp.asarray(ill))) < 1e-12
    assert _rel(imaging.illumination_compensate(_t(img), _t(ill),
                                                eps=0.1).numpy(),
                jim.illumination_compensate(jnp.asarray(img),
                                            jnp.asarray(ill), eps=0.1)) < 1e-12
    assert _rel(imaging.normalize_image(_t(img)).numpy(),
                jim.normalize_image(jnp.asarray(img))) < 1e-12
    zero = imaging.normalize_image(torch.zeros(4, 5, dtype=torch.float64))
    assert float(zero.abs().max()) == 0.0
