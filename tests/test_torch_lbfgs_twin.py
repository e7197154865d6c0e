"""optimize.lbfgs_on_device against the JAX package's on
tests/test_fwi_integration.py's bound-active twin (a vp bound below the
true anomaly), float64, the plain propagator in both packages on the same
numpy inputs: the first 5 values of the history equal JAX's to 1e-6
relative, and the returned model keeps the box.  (The quadratic is in
tests/test_torch_lbfgs.py.)
"""
import jax.numpy as jnp
import numpy as np
import torch

import sep2023_tpu as st
from sep2023_tpu import heads as jheads
from sep2023_tpu import optimize as joptimize
from sep2023_tpu import parallel as jparallel
from sep2023_tpu_torch import heads, optimize, parallel
from sep2023_tpu_torch.config import SimConfig, Survey
from torch_threads import one_thread  # noqa: F401  (autouse)


def test_bound_active_twin_matches_jax():
    npml, nzp, nxp = 8, 24, 40
    kw = dict(nz=nzp + 2 * npml, nx=nxp + 2 * npml, dz=20.0, dx=20.0,
              nt=160, dt=0.002, f0=10.0, npml=npml)
    vp_true = np.full((nzp, nxp), 3000.0)
    vp_true[9:15, 15:25] += 300.0
    vs_true = vp_true / np.sqrt(3.0)
    rho_true = np.full((nzp, nxp), 2500.0)
    sv = dict(src_z=np.full(3, 2), src_x=np.array([8, 20, 32]),
              rec_z=np.full(24, 20), rec_x=np.arange(8, 32))
    stf = np.broadcast_to(st.ricker(10.0, 160, 0.002), (3, 160))
    true = dict(vp=vp_true, vs=vs_true, rho=rho_true)
    start = {"vp": np.full((nzp, nxp), 3000.0)}
    bounds = {"vp": (2700.0, 3150.0)}   # below the 3300 m/s anomaly

    # the port, and its observed data for both packages
    cfg, survey = SimConfig(**kw), Survey(**sv)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    thead = heads.vp_vs_rho(cfg.grid, true,
                            mask=heads.default_mask(cfg.grid, 0))
    obs = parallel.make_forward(cfg, survey, use_kernels=False, device="cpu",
                                dtype=torch.float64)(
        *thead.apply({k: t(v) for k, v in true.items()}), t(stf)).numpy()

    # the JAX package: tests/test_fwi_integration.py's loss
    jcfg = st.SimConfig(**kw)
    geoms = jparallel.survey_to_geoms(st.Survey(**sv), npml,
                                      dtype=jnp.float64)
    head = jheads.vp_vs_rho(jcfg.grid, true,
                            mask=jheads.default_mask(jcfg.grid, 0))
    jdata = jparallel.make_local_misfit(jcfg, channels=("ett", "vx", "vz"))
    w = jnp.ones((3,), jnp.float64)

    def jloss(params, stf_, obs_):
        lam, mu, rho = head.apply({"vp": params["vp"],
                                   "vs": jnp.asarray(vs_true),
                                   "rho": jnp.asarray(rho_true)})
        return jdata(lam, mu, rho, stf_, geoms, obs_, w)

    _, hj = joptimize.lbfgs_on_device(jloss, start, 5, bounds=bounds,
                                      aux=(jnp.asarray(stf),
                                           jnp.asarray(obs)))

    tgeoms = parallel.survey_to_geoms(survey, npml, device="cpu",
                                      dtype=torch.float64)
    tdata = parallel.make_local_misfit(cfg, channels=("ett", "vx", "vz"))
    tw = torch.ones(3, dtype=torch.float64)

    def tloss(params, stf_, obs_):
        lam, mu, rho = thead.apply({"vp": params["vp"], "vs": t(vs_true),
                                    "rho": t(rho_true)})
        return tdata(lam, mu, rho, stf_, tgeoms, obs_, tw)

    params, ht = optimize.lbfgs_on_device(
        tloss, start, 5, bounds=bounds, aux=(t(stf), t(obs)), device="cpu",
        dtype=torch.float64)
    np.testing.assert_allclose(ht, hj, rtol=1e-6)
    assert ht[-1] < ht[0]
    vp = params["vp"].numpy()
    assert vp.max() <= 3150.0 and vp.min() >= 2700.0
