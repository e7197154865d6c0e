"""The first misfit of the port's Marmousi-scale and overthrust examples
against the JAX package's, on the CPU in float32: the examples'
objectives at their starting models (what their `main` reports as
misfit0), at tests/test_examples.py's sizes, equal the JAX misfit of the
same problem (true model, survey, wavelets, starting model) through
sep2023_tpu.parallel.make_local_misfit and the XLA propagator, to 1e-5
relative."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import parallel as jparallel

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import marmousi_scale_torch as tmarm  # noqa: E402
import overthrust_das_torch as tover  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)


def _jax_misfit(cfg, survey, lame, vp_true, vp_init, stf, das_w=None):
    """The L2 misfit of ett at vp_init (physical grid, edge-padded) against
    data of vp_true, in float32 through the JAX package's XLA engine."""
    jcfg = st.SimConfig(**dataclasses.asdict(cfg))
    geoms = jparallel.survey_to_geoms(
        st.Survey(src_z=survey.src_z, src_x=survey.src_x,
                  rec_z=survey.rec_z, rec_x=survey.rec_x), cfg.npml)
    S = survey.n_shots
    if das_w is not None:
        geoms = geoms._replace(das_w=jnp.broadcast_to(
            jnp.asarray(das_w, jnp.float32), (S, *np.shape(das_w))))
    pad = lambda vp: jnp.pad(jnp.asarray(vp, jnp.float32), cfg.npml,
                             mode="edge")
    stf = jnp.broadcast_to(jnp.asarray(stf, jnp.float32), (S, cfg.nt))
    obs = jax.vmap(lambda s, g: st.propagate(jcfg, *lame(pad(vp_true)), s,
                                             g))(stf, geoms)
    loss = jparallel.make_local_misfit(jcfg, channels=("ett",))
    return float(loss(*lame(pad(vp_init)), stf, geoms, obs,
                      jnp.ones((S,), jnp.float32)))


def test_marmousi_misfit0_matches_jax():
    cfg, survey, vp_t, _, vp_0, _, _ = tmarm.problem(
        nz=48, nx=64, nt=280, n_shots=2, npml=12, f0=18.0)
    obj = tmarm.objective(cfg, survey, vp_t, vp_0, 2, "cpu")
    port = obj.fun(obj.x0)

    def lame(vp):
        vs = vp / jnp.sqrt(3.0)
        rho = jnp.full_like(vp, tmarm.RHO)
        return (vp ** 2 - 2 * vs ** 2) * rho, vs ** 2 * rho, rho

    ref = _jax_misfit(cfg, survey, lame, vp_t, vp_0,
                      st.ricker(cfg.f0, cfg.nt, cfg.dt))
    assert abs(port - ref) <= 1e-5 * abs(ref), (port, ref)


def test_overthrust_misfit0_matches_jax():
    cfg, survey, das_w, vp_true, vp_init, _ = tover.problem(nt=260,
                                                            src_step=25)
    obj = tover.objective(cfg, survey, das_w, vp_true, vp_init, "cpu")
    port = obj.fun(obj.x0)

    def lame(vp):
        vs = vp / jnp.sqrt(3.0)
        rho = jnp.full_like(vp, 2300.0)
        return (vp ** 2 - 2 * vs ** 2) * rho, vs ** 2 * rho, rho

    ref = _jax_misfit(cfg, survey, lame, vp_true, vp_init,
                      st.ricker(cfg.f0, cfg.nt, cfg.dt), das_w)
    assert abs(port - ref) <= 1e-5 * abs(ref), (port, ref)
