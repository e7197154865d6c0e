"""Wavefield snapshots: the port's forward with snapshots against the JAX
package's, on the CPU.

* propagator.propagate_snapshots (plain PyTorch, float64) against
  sep2023_tpu.propagator.propagate_snapshots (XLA, float64): the data and
  every snapshot of every field to 1e-12 of each one's max, with an nt-1
  that save_every divides and one that it does not (the remainder is not
  run: n_chunks = (nt-1) // save_every, used + 1 samples).
* cuda_engine.snapshots_cuda_plan on CPU tensors takes its plain version,
  bit for bit: its data are the plain forward's over used + 1 samples, its
  last snapshot the plain forward's final fields, on a receiver row and on
  weighted point receivers; a save_every below 1 raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu.propagator import propagate_snapshots as jsnapshots
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import propagator
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.testing import fiber_problem, row_problem
from torch_threads import one_thread  # noqa: F401  (autouse)

NPML = 8


@pytest.mark.parametrize("nt,save_every", [(121, 20), (118, 25)],
                         ids=["divides", "remainder"])
def test_snapshots_match_jax(nt, save_every):
    kw = dict(nz=40 + 2 * NPML, nx=64 + 2 * NPML, dz=10.0, dx=10.0, nt=nt,
              dt=0.001, f0=20.0, npml=NPML)
    rng = np.random.default_rng(3)
    shape = (kw["nz"], kw["nx"])
    vp = 3000.0 + 200.0 * rng.random(shape)
    vs = vp / np.sqrt(3.0)
    rho = 2400.0 + 100.0 * rng.random(shape)
    lam, mu = (vp ** 2 - 2 * vs ** 2) * rho, vs ** 2 * rho
    stf = st.ricker(20.0, nt, 0.001)
    rec_z, rec_x = np.full(30, NPML + 30), np.arange(NPML + 10, NPML + 40)
    jgeom = st.ShotGeom(src_z=jnp.int32(NPML + 3), src_x=jnp.int32(NPML + 20),
                        rxz=jnp.float64(1.3), rec_z=jnp.asarray(rec_z),
                        rec_x=jnp.asarray(rec_x))
    d_ref, s_ref = jsnapshots(st.SimConfig(**kw), jnp.asarray(lam),
                              jnp.asarray(mu), jnp.asarray(rho),
                              jnp.asarray(stf), jgeom, save_every=save_every)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    geom = propagator.ShotGeom(
        src_z=torch.tensor(NPML + 3), src_x=torch.tensor(NPML + 20),
        rxz=t(1.3), rec_z=torch.tensor(rec_z), rec_x=torch.tensor(rec_x))
    data, snaps = propagator.propagate_snapshots(
        tcfg.SimConfig(**kw), t(lam), t(mu), t(rho), t(stf), geom,
        save_every=save_every)
    n_chunks = (nt - 1) // save_every
    assert data.shape == (4, 30, n_chunks * save_every + 1) == d_ref.shape
    assert isinstance(snaps, propagator.Fields)
    d_ref = np.asarray(d_ref)
    assert np.abs(data.numpy() - d_ref).max() <= 1e-12 * np.abs(d_ref).max()
    for name, a, b in zip(propagator.Fields._fields, snaps, s_ref):
        b = np.asarray(b)
        assert a.shape == b.shape == (n_chunks, *shape), name
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max(), name


@pytest.mark.parametrize("case", ["row", "points"])
def test_snapshot_route_on_cpu_is_the_plain_version(case):
    if case == "row":
        cfg, rs, args = row_problem(44, 60, 10, 120, 2, 38, device="cpu")
    else:
        cfg, rs, args = fiber_problem("arc weighted", device="cpu")
    plan = cuda_engine.plan_for(cfg, rs)
    save_every = 25
    before = cuda_engine.PLAIN_CALLS["snapshots_plain"]
    data, snaps = cuda_engine.snapshots_cuda_plan(plan, *args,
                                                  save_every=save_every)
    assert cuda_engine.PLAIN_CALLS["snapshots_plain"] == before + 1
    cfg_s = propagator.snapshot_config(cfg, save_every)
    assert cfg_s.nt == (cfg.nt - 1) // save_every * save_every + 1
    lam, mu, rho, stf, *src = args
    ref, _, final = cuda_engine.forward_plain_strips(
        cfg_s, rs, lam, mu, rho, stf[:, :cfg_s.nt], *src)
    S = stf.shape[0]
    assert data.dtype == torch.float32
    assert snaps.shape == ((cfg.nt - 1) // save_every, 5, S, cfg.nz, cfg.nx)
    assert torch.equal(data, ref)
    assert torch.equal(snaps[-1], final)
    assert float(snaps.abs().max()) > 0
    with pytest.raises(ValueError, match="save_every"):
        cuda_engine.snapshots_cuda_plan(plan, *args, save_every=0)
