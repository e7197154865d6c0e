"""2-D elastic velocity-stress propagator with CPML: the plain PyTorch
version (forward half).

PyTorch counterpart of `sep2023_tpu/propagator.py` (the XLA engine).  The
same update order as the reference CUDA engine (`libCUFD.cu:281-330`):
stress -> source -> velocity -> record, with the division-free CPML form
(cpml.CpmlScaled).  The shot axis is written out: every field is
(S, nz, nx), and the material planes and profiles broadcast against it.

This is the port's reference: the CPU tests hold it equal to the JAX
engine, and the CUDA kernel (ops/cuda_engine.py) is held equal to it.  The
boundary-saving adjoint comes with the gradient (ROADMAP M2).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sep2023_tpu_torch import cpml as cpml_mod
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.medium import MatFields, material_fields
from sep2023_tpu_torch.ops import fd

CHANNELS = ("pr", "vx", "vz", "ett")
N_CHANNELS = 4


class Fields(NamedTuple):
    vz: torch.Tensor
    vx: torch.Tensor
    szz: torch.Tensor
    sxx: torch.Tensor
    sxz: torch.Tensor


class Psi(NamedTuple):
    """CPML memory variables (one per stencil derivative), cf. the eight
    d_mem_* arrays in `libCUFD.cu:98-99`."""

    vz_dz: torch.Tensor
    vx_dx: torch.Tensor
    vx_dz: torch.Tensor
    vz_dx: torch.Tensor
    szz_dz: torch.Tensor
    sxz_dx: torch.Tensor
    sxz_dz: torch.Tensor
    sxx_dx: torch.Tensor


class State(NamedTuple):
    f: Fields
    psi: Psi


class ShotGeom(NamedTuple):
    """Acquisition of S shots (indices already on the padded grid).

    das_w: optional (S, R, 3) per-receiver fiber sensitivity weights for the
    (exx, exz, ezz) strain-rate components, used when
    cfg.das_channel == 'weighted'.
    """

    src_z: torch.Tensor  # (S,) int64
    src_x: torch.Tensor  # (S,) int64
    rxz: torch.Tensor    # (S,) float: sxx/szz source moment ratio
    rec_z: torch.Tensor  # (S, R) int64
    rec_x: torch.Tensor  # (S, R) int64
    das_w: torch.Tensor | None = None


def zero_state(shape, *, device, dtype) -> State:
    z = lambda: torch.zeros(shape, device=device, dtype=dtype)
    return State(f=Fields(z(), z(), z(), z(), z()),
                 psi=Psi(z(), z(), z(), z(), z(), z(), z(), z()))


def _consts(cfg: SimConfig, *, device, dtype):
    """CPML profiles (division-free scaled form, built in float64 and cast)
    and the forward update mask [2, n-3] (el_stress.cu:52)."""
    cp = cpml_mod.cpml_scaled(cfg.nz, cfg.nx, cfg.npml, cfg.dz, cfg.dx,
                              cfg.dt, cfg.f0, dtype=np.float64)
    cp = cpml_mod.CpmlScaled(*(torch.as_tensor(p).to(device, dtype)
                               for p in cp))
    mask_f = fd.update_mask(cfg.nz, cfg.nx, 2, cfg.nz - 3, 2, cfg.nx - 3,
                            device=device, dtype=dtype)
    return cp, mask_f


# ---------------------------------------------------------------------------
# Forward step
# ---------------------------------------------------------------------------

def _stress_update(f: Fields, psi: Psi, mat: MatFields, cp, mask, cfg):
    # division-free CPML form (cpml.CpmlScaled): psi <- b psi + a' D,
    # d_eff = D ik + psi on the RAW stencil differences D
    mz, mx = mask
    dt = cfg.dt
    d_vz = fd.dz_minus(f.vz)
    p_vz_dz = cp.bz * psi.vz_dz + cp.az * d_vz
    dvz = d_vz * cp.ikz + p_vz_dz

    d_vx = fd.dx_minus(f.vx)
    p_vx_dx = cp.bx * psi.vx_dx + cp.ax * d_vx
    dvx = d_vx * cp.ikx + p_vx_dx

    szz = f.szz + (mz * mx) * ((mat.lp2m * dvz + mat.lam * dvx) * dt)
    sxx = f.sxx + (mz * mx) * ((mat.lam * dvz + mat.lp2m * dvx) * dt)

    d_vxz = fd.dz_plus(f.vx)
    p_vx_dz = cp.bz_h * psi.vx_dz + cp.az_h * d_vxz
    dvxz = d_vxz * cp.ikz_h + p_vx_dz

    d_vzx = fd.dx_plus(f.vz)
    p_vz_dx = cp.bx_h * psi.vz_dx + cp.ax_h * d_vzx
    dvzx = d_vzx * cp.ikx_h + p_vz_dx

    sxz = f.sxz + (mz * mx) * (mat.ave_mu * (dvxz + dvzx) * dt)
    return (szz, sxx, sxz), (p_vz_dz, p_vx_dx, p_vx_dz, p_vz_dx)


def _velocity_update(f: Fields, psi: Psi, mat: MatFields, cp, mask, cfg):
    mz, mx = mask
    dt = cfg.dt
    d_szz = fd.dz_plus(f.szz)
    p_szz_dz = cp.bz_h * psi.szz_dz + cp.az_h * d_szz
    dszz = d_szz * cp.ikz_h + p_szz_dz

    d_sxzx = fd.dx_minus(f.sxz)
    p_sxz_dx = cp.bx * psi.sxz_dx + cp.ax * d_sxzx
    dsxzx = d_sxzx * cp.ikx + p_sxz_dx

    vz = f.vz + (mz * mx) * ((dszz + dsxzx) * mat.byc_a * dt)

    d_sxzz = fd.dz_minus(f.sxz)
    p_sxz_dz = cp.bz * psi.sxz_dz + cp.az * d_sxzz
    dsxzz = d_sxzz * cp.ikz + p_sxz_dz

    d_sxx = fd.dx_plus(f.sxx)
    p_sxx_dx = cp.bx_h * psi.sxx_dx + cp.ax_h * d_sxx
    dsxx = d_sxx * cp.ikx_h + p_sxx_dx

    vx = f.vx + (mz * mx) * ((dsxzz + dsxx) * mat.byc_b * dt)
    return (vz, vx), (p_szz_dz, p_sxz_dx, p_sxz_dz, p_sxx_dx)


def _record(f: Fields, geom: ShotGeom, cfg: SimConfig):
    """Sample the 4 channels at the receivers (utilities.cu:593-703):
    (S, 4, R).

    ett is the un-normalized fiber strain-rate: a difference of the particle
    velocity along the fiber axis (NOT divided by dx, matching
    `recording_exx`, utilities.cu:600-601)."""
    s = torch.arange(geom.rec_z.shape[0], device=geom.rec_z.device)[:, None]
    rz, rx = geom.rec_z, geom.rec_x
    pr = f.szz[s, rz, rx] + f.sxx[s, rz, rx]
    vxr = f.vx[s, rz, rx]
    vzr = f.vz[s, rz, rx]
    if cfg.das_channel == "ezz":
        ett = f.vz[s, rz, rx] - f.vz[s, rz - 1, rx]
    elif cfg.das_channel == "weighted":
        # directional fiber sampling with per-channel sensitivity weights on
        # (exx, exz, ezz) (elasticSolver.py:269-276), normalized by dx/dz
        exx = (f.vx[s, rz, rx] - f.vx[s, rz, rx - 1]) / cfg.dx
        ezz = (f.vz[s, rz, rx] - f.vz[s, rz - 1, rx]) / cfg.dz
        exz = 0.5 * ((f.vx[s, rz + 1, rx] - f.vx[s, rz, rx]) / cfg.dz
                     + (f.vz[s, rz, rx + 1] - f.vz[s, rz, rx]) / cfg.dx)
        w = geom.das_w
        ett = w[..., 0] * exx + w[..., 1] * exz + w[..., 2] * ezz
    else:
        ett = f.vx[s, rz, rx] - f.vx[s, rz, rx - 1]
    return torch.stack([pr, vxr, vzr, ett], dim=1)


def _add_source(szz, sxx, amp, geom: ShotGeom, cfg: SimConfig, sign=1.0):
    """Explosive point source into szz+sxx (utilities.cu:524-552); amp is
    (S,), one sample per shot."""
    s = sign * cfg.src_scale * cfg.dt * amp
    idx = (torch.arange(amp.shape[0], device=amp.device),
           geom.src_z, geom.src_x)
    szz = szz.index_put(idx, s, accumulate=True)
    sxx = sxx.index_put(idx, geom.rxz * s, accumulate=True)
    return szz, sxx


def elastic_step(state: State, mat: MatFields, amp, geom: ShotGeom,
                 cp, mask_f, cfg: SimConfig):
    """One full leapfrog step: stress -> source -> velocity -> record,
    mirroring the kernel order in `libCUFD.cu:281-330`."""
    f, psi = state
    (szz, sxx, sxz), (p1, p2, p3, p4) = _stress_update(f, psi, mat, cp,
                                                       mask_f, cfg)
    szz, sxx = _add_source(szz, sxx, amp, geom, cfg)
    f2 = Fields(f.vz, f.vx, szz, sxx, sxz)
    psi2 = Psi(p1, p2, p3, p4, psi.szz_dz, psi.sxz_dx, psi.sxz_dz,
               psi.sxx_dx)
    (vz, vx), (p5, p6, p7, p8) = _velocity_update(f2, psi2, mat, cp, mask_f,
                                                  cfg)
    f3 = Fields(vz, vx, szz, sxx, sxz)
    psi3 = Psi(p1, p2, p3, p4, p5, p6, p7, p8)
    return State(f3, psi3), _record(f3, geom, cfg)


# ---------------------------------------------------------------------------
# Forward scan
# ---------------------------------------------------------------------------

def _forward(cfg: SimConfig, lam, mu, rho, stf, geom: ShotGeom):
    """All shots of `geom` over nt-1 steps: data (S, 4, R, nt), sample 0
    zero (recording index it+1, libCUFD.cu:310)."""
    dtype, device = lam.dtype, lam.device
    S, R = geom.rec_z.shape
    mat = material_fields(lam, mu, rho)
    cp, mask_f = _consts(cfg, device=device, dtype=dtype)
    state = zero_state((S, cfg.nz, cfg.nx), device=device, dtype=dtype)
    data = torch.zeros((S, N_CHANNELS, R, cfg.nt), device=device,
                       dtype=dtype)
    for it in range(cfg.nt - 1):
        state, rec = elastic_step(state, mat, stf[:, it], geom, cp, mask_f,
                                  cfg)
        data[..., it + 1] = rec
    return data


def propagate(cfg: SimConfig, lam, mu, rho, stf, geom: ShotGeom):
    """Simulate one shot (stf (nt,), geom fields without the shot axis);
    returns seismograms shaped (4, n_rec, nt), channels (pr, vx, vz, ett)."""
    one = ShotGeom(*(None if g is None else g[None] for g in geom))
    return _forward(cfg, lam, mu, rho, stf[None], one)[0]


def propagate_shots(cfg: SimConfig, lam, mu, rho, stf, geoms: ShotGeom):
    """All shots at once: stf (S, nt), geoms fields lead with S; returns
    (S, 4, n_rec, nt).  Replaces the shot loop of `Torch_Fwi.cpp:71-95`."""
    return _forward(cfg, lam, mu, rho, stf, geoms)
