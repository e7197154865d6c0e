"""What the fused elastic kernels are given, on the CPU.

* cuda_engine.cpml_bands: the scaled CPML profiles' a and a_h are exactly 0
  between the bands the wrappers pass to the kernels, at the reference
  grid, 560x720, 814x2064 and the small test grids (the JAX package's
  profiles agree), so a kernel that keeps no memory there drops nothing.
* The port's plain forward in float64 on a 64x96 grid: after the last step
  every CPML memory is exactly 0 outside its band.
* launches_forward / launches_backward, the plane counts and
  state_bytes_per_shot against their formulas.
"""
import numpy as np
import pytest
import torch

from sep2023_tpu import cpml as jcpml
from sep2023_tpu_torch import parallel, propagator
from sep2023_tpu_torch.config import SimConfig, ricker
from sep2023_tpu_torch.medium import material_fields
from sep2023_tpu_torch.ops import cuda_engine as ce
from sep2023_tpu_torch.propagator import ShotGeom

# (nz, nx, npml, dh, dt, f0) padded: the reference workload, the two large
# grids, and the grids of testing.ROW_CASES / FIBER_CASES / TILE_EDGE_CASES
GRIDS = {
    "reference 165x265": (165, 265, 32, 20.0, 0.002, 10.0),
    "560x720": (560, 720, 32, 10.0, 0.001, 10.0),
    "814x2064": (814, 2064, 32, 10.0, 0.001, 6.0),
    "small 64x80": (64, 80, 10, 20.0, 0.002, 10.0),
    "fiber 64x80 at 10 m": (64, 80, 10, 10.0, 0.001, 15.0),
    "ragged 65x81": (65, 81, 10, 20.0, 0.002, 10.0),
    "under one tile 14x26": (14, 26, 3, 20.0, 0.002, 10.0),
    "wide band 110x130": (110, 130, 40, 20.0, 0.002, 10.0),
}


def _cfg(nz, nx, npml, dh, dt, f0, nt=11):
    return SimConfig(nz=nz, nx=nx, dz=dh, dx=dh, nt=nt, dt=dt, f0=f0,
                     npml=npml)


@pytest.mark.parametrize("grid", GRIDS)
def test_cpml_bands_hold_every_nonzero_a(grid):
    """a and a_h of both axes are 0 exactly on [lo, hi) and not 0 at the
    grid's edge; the bands are the npml cells of each side; the JAX
    package's float32 profiles give the same bands."""
    nz, nx, npml, dh, dt, f0 = GRIDS[grid]
    cfg = _cfg(*GRIDS[grid])
    z_lo, z_hi, x_lo, x_hi = ce.cpml_bands(cfg)
    assert (z_lo, z_hi, x_lo, x_hi) == (npml, nz - npml, npml, nx - npml)
    pz, px = ce._profile_rows(cfg)
    jp = jcpml.cpml_scaled(nz, nx, npml, dh, dh, dt, f0, dtype=np.float32)
    for rows, (lo, hi), ja in ((pz, (z_lo, z_hi), (jp.az, jp.az_h)),
                               (px, (x_lo, x_hi), (jp.ax, jp.ax_h))):
        for k, j in ((1, ja[0]), (4, ja[1])):   # a, a_h
            a = rows[k]
            np.testing.assert_array_equal(a, np.asarray(j).reshape(-1))
            assert (a[lo:hi] == 0).all()
            assert a[0] != 0 and a[-1] != 0
    assert ce.band_floats(cfg) == ((nz - (z_hi - z_lo)) * nx
                                   + nz * (nx - (x_hi - x_lo)))


def test_plain_forward_memories_vanish_outside_the_bands():
    """The plain forward (propagator.elastic_step), float64, 64x96 padded,
    nt=240, two shots: after the last step the 8 CPML memories are exactly
    0 outside their bands (z-memories on rows, x-memories on columns) and
    not 0 inside them."""
    npml, nt = 10, 240
    cfg = SimConfig(nz=64, nx=96, dz=20.0, dx=20.0, nt=nt, dt=0.002, f0=10.0,
                    npml=npml)
    f64 = dict(device="cpu", dtype=torch.float64)
    vp = torch.full((cfg.nz, cfg.nx), 3000.0, **f64)
    vp[20:40, 30:60] += 300.0
    rho = torch.full_like(vp, 2400.0)
    mu = rho * (vp / np.sqrt(3.0)) ** 2
    lam = rho * vp ** 2 - 2 * mu
    mat = material_fields(lam, mu, rho)
    cp, mask = propagator._consts(cfg, **f64)
    geom = ShotGeom(src_z=torch.tensor([11, 40]), src_x=torch.tensor([20, 70]),
                    rxz=torch.ones(2, **f64),
                    rec_z=torch.full((2, 5), 30),
                    rec_x=torch.arange(40, 45).expand(2, 5))
    stf = torch.as_tensor(ricker(cfg.f0, nt, cfg.dt), **f64)
    state = propagator.zero_state((2, cfg.nz, cfg.nx), **f64)
    for it in range(nt - 1):
        state, _ = propagator.elastic_step(state, mat, stf[it].expand(2),
                                           geom, cp, mask, cfg)
    z_lo, z_hi, x_lo, x_hi = ce.cpml_bands(cfg)
    psi = state.psi
    for name in ("vz_dz", "vx_dz", "szz_dz", "sxz_dz"):
        m = getattr(psi, name)
        assert float(m[:, z_lo:z_hi].abs().max()) == 0.0, name
        assert float(m.abs().max()) > 0.0, name
    for name in ("vx_dx", "vz_dx", "sxz_dx", "sxx_dx"):
        m = getattr(psi, name)
        assert float(m[:, :, x_lo:x_hi].abs().max()) == 0.0, name
        assert float(m.abs().max()) > 0.0, name


@pytest.mark.parametrize("grid", ["reference 165x265", "814x2064",
                                  "under one tile 14x26"])
def test_launch_and_plane_counts(grid):
    """nt launches a forward (nt-1 fused steps, each recording the state it
    reads, and the record-only launch of the last sample); 1 a reverse step
    for a receiver row and for point receivers (their cotangents added
    inside it), and the shot sum; 35 planes
    of nz x nx a shot (final fields, the double-buffered fields, 15 work
    planes, 5 gradients) and 6 band planes of CPML memory of each axis."""
    cfg = _cfg(*GRIDS[grid], nt=1501)
    row = ce.RowSurvey(cfg.npml + 2, 3, 5)
    fiber = ce.make_fiber_survey([5, 6], [7, 8])
    assert ce.launches_forward(cfg) == 1500 + 1
    assert ce.launches_backward(cfg, row) == 1500 + 1
    assert ce.launches_backward(cfg, fiber) == 1500 + 1
    assert (ce.N_STATE_PLANES, ce.N_WORK_PLANES, ce.N_GRAD_PLANES,
            ce.N_BAND_PLANES) == (10, 15, 5, 6)
    n = cfg.npml
    band = 2 * n * cfg.nx + cfg.nz * 2 * n
    assert ce.band_floats(cfg) == band
    assert parallel.state_bytes_per_shot(cfg) == \
        4 * (35 * cfg.nz * cfg.nx + 6 * band)
    assert parallel.state_bytes_per_shot(cfg, itemsize=8) == \
        2 * parallel.state_bytes_per_shot(cfg)
