"""The port's elastic forward against the JAX engines.

* propagator.propagate_shots (plain PyTorch, float64) against
  sep2023_tpu.propagator.propagate under jax.vmap (XLA, float64): 1e-10 of
  each channel's max.
* cuda_engine.forward_cuda_plan on CPU tensors (float32, so its plain version)
  against pallas_engine.forward_pallas in interpret mode: 2e-5 of each
  channel's max, the tolerance the JAX package holds between Pallas and XLA.

The receivers sit 14 rows below the sources so that the direct P and S
arrivals reach them well inside nt: a comparison of traces that saw no wave
would compare round-off only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu import parallel
from sep2023_tpu.config import Survey
from sep2023_tpu.ops import pallas_engine as pe
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import convert, propagator
from sep2023_tpu_torch.ops import cuda_engine

NPML = 10
NT = 160


def _problem(das_channel):
    """npml=10, 44x60 interior, 2 shots, receivers on one row; numpy
    arrays made from a seed, and the config of both packages."""
    kw = dict(nz=44 + 2 * NPML, nx=60 + 2 * NPML, dz=20.0, dx=20.0, nt=NT,
              dt=0.002, f0=10.0, npml=NPML, das_channel=das_channel)
    rng = np.random.default_rng(7)
    shape = (kw["nz"], kw["nx"])
    vp = 3000.0 + 50.0 * rng.standard_normal(shape)
    vp[30:38, 40:52] += 250.0
    vs = vp / np.sqrt(3.0)
    rho = 2500.0 + 20.0 * rng.standard_normal(shape)
    lam = (vp ** 2 - 2.0 * vs ** 2) * rho
    mu = vs ** 2 * rho
    survey = Survey(src_z=np.array([2, 2]), src_x=np.array([14, 40]),
                    rec_z=np.full(24, 16), rec_x=np.arange(16, 40),
                    src_rxz=np.array([1.0, 1.7]))
    stf = np.stack([st.ricker(10.0, NT, 0.002),
                    0.5 * st.ricker(12.0, NT, 0.002)])
    return st.SimConfig(**kw), tcfg.SimConfig(**kw), lam, mu, rho, stf, survey


def _assert_channels_close(out, ref, tol):
    assert out.shape == ref.shape
    for c in range(4):
        scale = np.abs(ref[:, c]).max()
        rel = np.abs(out[:, c] - ref[:, c]).max() / scale
        assert rel < tol, (c, rel)


def _assert_arrivals(data):
    """ett carries a wave: its peak is far above float noise and above the
    first samples, before any wave can reach the receivers."""
    ett = np.abs(data[:, 3])
    assert ett.max() > 1e-3
    assert ett[..., :20].max() < 1e-6 * ett.max()


@pytest.mark.parametrize("das_channel", ["exx", "ezz", "weighted"])
def test_plain_matches_xla_f64(das_channel):
    jcfg, tcfg_, lam, mu, rho, stf, survey = _problem(das_channel)
    geoms = parallel.survey_to_geoms(survey, NPML, dtype=jnp.float64)
    if das_channel == "weighted":
        w = np.random.default_rng(8).uniform(-1.0, 1.0, (2, 24, 3))
        geoms = geoms._replace(das_w=jnp.asarray(w))
    ref = np.asarray(jax.vmap(lambda s, g: st.propagate(
        jcfg, jnp.asarray(lam), jnp.asarray(mu), jnp.asarray(rho), s, g))(
            jnp.asarray(stf), geoms))
    args = convert.params_from_numpy(lam, mu, rho, stf, geoms, device="cpu",
                                     dtype=torch.float64)
    out = propagator.propagate_shots(tcfg_, *args).numpy()
    _assert_arrivals(ref)
    _assert_channels_close(out, ref, 1e-10)

    # the one-shot entry point is the batched one at S=1
    lam_t, mu_t, rho_t, stf_t, g = args
    one = propagator.ShotGeom(*(None if a is None else a[1] for a in g))
    np.testing.assert_array_equal(
        propagator.propagate(tcfg_, lam_t, mu_t, rho_t, stf_t[1], one).numpy(),
        out[1])


@pytest.mark.parametrize("das_channel", ["exx", "ezz"])
def test_forward_cuda_cpu_matches_pallas(das_channel):
    jcfg, tcfg_, lam, mu, rho, stf, survey = _problem(das_channel)
    npml = NPML
    f32 = np.float32
    rs = pe.check_row_survey(survey.rec_z + npml, survey.rec_x + npml)
    ref = np.asarray(pe.forward_pallas(
        jcfg, rs, jnp.asarray(lam, jnp.float32), jnp.asarray(mu, jnp.float32),
        jnp.asarray(rho, jnp.float32), jnp.asarray(stf, jnp.float32),
        survey.src_z + npml, survey.src_x + npml, survey.src_rxz))

    trs = cuda_engine.check_row_survey(survey.rec_z + npml,
                                       survey.rec_x + npml)
    assert tuple(trs) == tuple(rs)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, f32))
    before = cuda_engine.LAUNCHES
    out = cuda_engine.forward_cuda_plan(
        cuda_engine.plan_for(tcfg_, trs), t(lam), t(mu), t(rho), t(stf),
        survey.src_z + npml, survey.src_x + npml, survey.src_rxz)
    assert cuda_engine.LAUNCHES == before  # the CPU path launches nothing
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    _assert_arrivals(ref)
    _assert_channels_close(out.numpy(), ref, 2e-5)
