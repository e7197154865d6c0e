"""What the fused acoustic kernels are given, on the CPU.

* cuda_engine.cpml_bands holds every nonzero a and a_h of the acoustic
  profiles that the JAX package's acoustic engine builds
  (sep2023_tpu/acoustic.py `_consts`), at the reference grid, 560x720,
  814x2064 and every AC_TILE_EDGE_CASES grid, so a kernel that keeps no
  memory outside the bands drops nothing.
* The port's plain acoustic forward in float64 on a 64x96 grid: after the
  last step every CPML memory is exactly 0 outside its band.
* launches_forward_acoustic, launches_backward_acoustic and
  state_bytes_per_shot(acoustic=True) against their formulas.
* The plain acoustic forward and its adjoint on every AC_TILE_EDGE_CASES
  case against the JAX package's XLA acoustic engine
  (acoustic.propagate_acoustic and its custom VJP), float64: data within
  1e-12 of each channel's max, the cotangents of (lam, rho, stf) of a
  seeded data cotangent within 1e-12 of each one's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu import acoustic as jac
from sep2023_tpu_torch import acoustic, parallel
from sep2023_tpu_torch.config import SimConfig, ricker
from sep2023_tpu_torch.ops import cuda_acoustic as ca
from sep2023_tpu_torch.ops import cuda_engine as ce
from sep2023_tpu_torch.testing import (AC_TILE_EDGE_CASES,
                                       ac_tile_edge_problem)

F64_TOL = 1e-12


def _edge_grid(case):
    nz, nx, npml = AC_TILE_EDGE_CASES[case][:3]
    return (nz + 2 * npml, nx + 2 * npml, npml, 20.0, 0.002, 10.0)


# (nz, nx, npml, dh, dt, f0) padded: the reference workload, the two large
# grids, and every AC_TILE_EDGE_CASES grid
GRIDS = {
    "reference 165x265": (165, 265, 32, 20.0, 0.002, 10.0),
    "560x720": (560, 720, 32, 10.0, 0.001, 10.0),
    "814x2064": (814, 2064, 32, 10.0, 0.001, 6.0),
    **{f"tile edges: {case}": _edge_grid(case)
       for case in AC_TILE_EDGE_CASES},
}


def _cfgs(nz, nx, npml, dh, dt, f0, nt=11):
    kw = dict(nz=nz, nx=nx, dz=dh, dx=dh, nt=nt, dt=dt, f0=f0, npml=npml)
    return st.SimConfig(**kw), SimConfig(**kw)


@pytest.mark.parametrize("grid", GRIDS)
def test_cpml_bands_hold_the_acoustic_profiles(grid):
    """a and a_h of the JAX acoustic engine's profiles (float32, as the
    kernels read them) are 0 exactly between the bands and not 0 at the
    grid's edge; the bands are the npml cells of each side."""
    nz, nx, npml = GRIDS[grid][:3]
    jcfg, cfg = _cfgs(*GRIDS[grid])
    z_lo, z_hi, x_lo, x_hi = ce.cpml_bands(cfg)
    assert (z_lo, z_hi, x_lo, x_hi) == (npml, nz - npml, npml, nx - npml)
    cp = jac._consts(jcfg, jnp.float32)[0]
    pz, px = ce._profile_rows(cfg)
    for rows, (lo, hi), ja in ((pz, (z_lo, z_hi), (cp.az, cp.az_h)),
                               (px, (x_lo, x_hi), (cp.ax, cp.ax_h))):
        for k, j in ((1, ja[0]), (4, ja[1])):   # a, a_h
            a = np.asarray(j).reshape(-1)
            np.testing.assert_array_equal(rows[k], a)
            assert (a[lo:hi] == 0).all()
            assert a[0] != 0 and a[-1] != 0


def test_plain_acoustic_memories_vanish_outside_the_bands():
    """The plain acoustic forward (acoustic.ac_step), float64, 64x96
    padded, nt=240, two shots: after the last step the 4 CPML memories are
    exactly 0 outside their bands (z-memories on rows, x-memories on
    columns) and not 0 inside them."""
    npml, nt = 10, 240
    cfg = SimConfig(nz=64, nx=96, dz=20.0, dx=20.0, nt=nt, dt=0.002,
                    f0=10.0, npml=npml)
    f64 = dict(device="cpu", dtype=torch.float64)
    vp = torch.full((cfg.nz, cfg.nx), 3000.0, **f64)
    vp[20:40, 30:60] += 300.0
    rho = torch.full_like(vp, 2400.0)
    byc_a, byc_b = acoustic._buoyancies(rho)
    cp, mask_f, _ = acoustic._consts(cfg, **f64)
    geom = acoustic.AcGeom(src_z=torch.tensor([11, 40]),
                           src_x=torch.tensor([20, 70]),
                           rec_z=torch.full((2, 5), 30),
                           rec_x=torch.arange(40, 45).expand(2, 5))
    stf = torch.as_tensor(ricker(cfg.f0, nt, cfg.dt), **f64)
    state = acoustic._zero_state((2, cfg.nz, cfg.nx), **f64)
    for it in range(nt - 1):
        state, _ = acoustic.ac_step(state, rho * vp ** 2, byc_a, byc_b,
                                    stf[it].expand(2), geom, cp, mask_f, cfg)
    z_lo, z_hi, x_lo, x_hi = ce.cpml_bands(cfg)
    psi = state.psi
    for name in ("vz_dz", "p_dz"):
        m = getattr(psi, name)
        assert float(m[:, z_lo:z_hi].abs().max()) == 0.0, name
        assert float(m.abs().max()) > 0.0, name
    for name in ("vx_dx", "p_dx"):
        m = getattr(psi, name)
        assert float(m[:, :, x_lo:x_hi].abs().max()) == 0.0, name
        assert float(m.abs().max()) > 0.0, name


@pytest.mark.parametrize("grid", ["reference 165x265", "814x2064",
                                  "tile edges: grid under one tile"])
def test_acoustic_launch_and_plane_counts(grid):
    """nt launches a forward (nt-1 fused steps, each recording the state
    it reads, and the record-only launch of the last sample); nt a
    backward, nt-1 fused reverse steps and the shot sum, for a receiver row
    and for point receivers alike; 21
    planes of nz x nx a shot (final fields, the double-buffered fields, 9
    work planes, 3 gradients) and 3 band planes of CPML memory of each
    axis."""
    _, cfg = _cfgs(*GRIDS[grid], nt=1501)
    row = ce.RowSurvey(cfg.npml + 2, 3, 5)
    fiber = ce.make_fiber_survey([5, 6], [7, 8])
    assert ca.launches_forward_acoustic(cfg) == 1500 + 1
    assert ca.launches_backward_acoustic(cfg, row) == 1500 + 1
    assert ca.launches_backward_acoustic(cfg, fiber) == 1500 + 1
    assert (ca.N_STATE_PLANES, ca.N_WORK_PLANES, ca.N_GRAD_PLANES,
            ca.N_BAND_PLANES) == (6, 9, 3, 3)
    n = cfg.npml
    band = 2 * n * cfg.nx + cfg.nz * 2 * n
    assert ce.band_floats(cfg) == band
    assert parallel.state_bytes_per_shot(cfg, acoustic=True) == \
        4 * (21 * cfg.nz * cfg.nx + 3 * band)
    assert parallel.state_bytes_per_shot(cfg, acoustic=True, itemsize=8) \
        == 2 * parallel.state_bytes_per_shot(cfg, acoustic=True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", list(AC_TILE_EDGE_CASES))
def test_tile_edge_case_matches_jax_f64(case):
    """The plain acoustic forward and its boundary-saving adjoint on an
    AC_TILE_EDGE_CASES case against the JAX XLA engine, float64, on the
    same numpy inputs: data per channel, and the cotangents of lam and rho
    (both kept inside the tight interior) and of stf for a seeded data
    cotangent."""
    cfg, rs, args = ac_tile_edge_problem(case, device="cpu")
    jcfg = st.SimConfig(nz=cfg.nz, nx=cfg.nx, dz=cfg.dz, dx=cfg.dx,
                        nt=cfg.nt, dt=cfg.dt, f0=cfg.f0, npml=cfg.npml)
    lam, rho, stf = (a.double().numpy() for a in args[:3])
    geoms = ca._geoms(cfg, rs, *args[3:], "cpu")
    S, R = geoms.rec_z.shape
    d = np.random.default_rng(11).standard_normal((S, 3, R, cfg.nt))

    ins = [torch.tensor(a, requires_grad=True) for a in (lam, rho, stf)]
    data = acoustic.propagate_acoustic_shots(cfg, *ins, geoms)
    grads = torch.autograd.grad(data, ins, torch.from_numpy(d))

    jgeoms = jac.AcGeom(*(jnp.asarray(g.numpy()) for g in geoms))
    fwd = lambda lam_, rho_, stf_: jax.vmap(
        lambda s, g: jac.propagate_acoustic(jcfg, lam_, rho_, s, g))(
            stf_, jgeoms)

    def data_and_vjp(lam_, rho_, stf_, d_):
        out, vjp = jax.vjp(fwd, lam_, rho_, stf_)
        return out, vjp(d_)

    # one compile of both scans
    ref, ref_grads = jax.jit(data_and_vjp)(
        *(jnp.asarray(a) for a in (lam, rho, stf, d)))

    data = data.detach().numpy()
    assert data.shape == ref.shape == (S, 3, R, cfg.nt)
    for c in range(3):
        assert np.abs(np.asarray(ref[:, c])).max() > 0
        assert _rel(data[:, c], ref[:, c]) < F64_TOL, c
    for name, a, b in zip(("lam", "rho", "stf"), grads, ref_grads):
        assert np.abs(np.asarray(b)).max() > 0, name
        assert _rel(a.numpy(), b) < F64_TOL, (name, _rel(a.numpy(), b))
