"""2-D elastic velocity-stress propagator with CPML and a boundary-saving
adjoint: the plain PyTorch version.

PyTorch counterpart of `sep2023_tpu/propagator.py` (the XLA engine).  The
same update order as the reference CUDA engine (`libCUFD.cu:281-330`):
stress -> source -> velocity -> record, with the division-free CPML form
(cpml.CpmlScaled).  The shot axis is written out: every field is
(S, nz, nx), and the material planes and profiles broadcast against it.

This is the port's reference: the CPU tests hold it equal to the JAX
engine, and the CUDA kernels (ops/cuda_engine.py) are held equal to it.

The gradient is the JAX engine's boundary-saving adjoint
(`sep2023_tpu/propagator.py:335-436`): the forward saves the 5-deep boundary
strips of the 5 fields before every step; the backward reconstructs the
state one step back by time-reversed interior updates plus the saved strips,
and takes autograd of `elastic_step` at the reconstructed state with zero
CPML memory.  Strips are stored flat, per shot and step, in the layout the
CUDA kernels share (`strip_len`, `_extract_strips`).
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


def _interior_mask(cfg: SimConfig, *, device, dtype):
    """The interior [npml, n-1-npml] (the reverse branch, el_stress.cu:92):
    where the reconstruction updates and where gradients are kept."""
    return fd.update_mask(cfg.nz, cfg.nx, cfg.npml, cfg.nz - 1 - cfg.npml,
                          cfg.npml, cfg.nx - 1 - cfg.npml, device=device,
                          dtype=dtype)


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
        # a neighbour past the last row or column wraps to the first, as
        # the index -1 does the other way: both lie outside the update
        # mask, where vz and vx stay 0 (the kernels read 0 off the grid)
        exz = 0.5 * ((f.vx[s, (rz + 1) % cfg.nz, rx] - f.vx[s, rz, rx])
                     / cfg.dz
                     + (f.vz[s, rz, (rx + 1) % cfg.nx] - f.vz[s, rz, rx])
                     / cfg.dx)
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
# Time-reversed reconstruction (interior only, no CPML; el_stress.cu:89-104,
# el_velocity.cu:84-98)
# ---------------------------------------------------------------------------

def _velocity_reverse(f: Fields, mat: MatFields, mask_i, cfg: SimConfig):
    # multiply by the reciprocal spacing (not divide): it matches the
    # forward's interior d_eff = D * ik, ik = dtype(1/dh) (cpml.CpmlScaled),
    # so forward and reverse compute the same interior increment
    mz, mx = mask_i
    dt = cfg.dt
    idz, idx = 1.0 / cfg.dz, 1.0 / cfg.dx
    dvz = fd.dz_plus(f.szz) * idz + fd.dx_minus(f.sxz) * idx
    dvx = fd.dz_minus(f.sxz) * idz + fd.dx_plus(f.sxx) * idx
    vz = f.vz - (mz * mx) * (dvz * mat.byc_a * dt)
    vx = f.vx - (mz * mx) * (dvx * mat.byc_b * dt)
    return Fields(vz, vx, f.szz, f.sxx, f.sxz)


def _stress_reverse(f: Fields, mat: MatFields, mask_i, cfg: SimConfig):
    mz, mx = mask_i
    dt = cfg.dt
    idz, idx = 1.0 / cfg.dz, 1.0 / cfg.dx
    dvz_dz = fd.dz_minus(f.vz) * idz
    dvx_dx = fd.dx_minus(f.vx) * idx
    szz = f.szz - (mz * mx) * ((mat.lp2m * dvz_dz + mat.lam * dvx_dx) * dt)
    sxx = f.sxx - (mz * mx) * ((mat.lam * dvz_dz + mat.lp2m * dvx_dx) * dt)
    dvx_dz = fd.dz_plus(f.vx) * idz
    dvz_dx = fd.dx_plus(f.vz) * idx
    sxz = f.sxz - (mz * mx) * (mat.ave_mu * (dvx_dz + dvz_dx) * dt)
    return Fields(f.vz, f.vx, szz, sxx, sxz)


# ---------------------------------------------------------------------------
# Boundary strips: one flat vector per field, shot and step
# ---------------------------------------------------------------------------

N_FIELDS = 5


def _strip_bounds(cfg: SimConfig):
    L = cfg.n_bnd_layers
    z0 = cfg.npml - 2                 # top strip start (utilities.cu:371)
    z1 = cfg.nz - cfg.npml - 3        # bottom strip start (utilities.cu:388)
    x0 = cfg.npml - 2
    x1 = cfg.nx - cfg.npml - 3
    return L, z0, z1, x0, x1


def strip_len(cfg: SimConfig) -> int:
    """Length of one field's strips: top (L, nx), bottom (L, nx), left
    (nz, L) and right (nz, L), each row-major, in that order."""
    return 2 * cfg.n_bnd_layers * (cfg.nz + cfg.nx)


def check_strip_grid(cfg: SimConfig) -> None:
    """The strips must lie inside the grid and not overlap each other."""
    L = cfg.n_bnd_layers
    if cfg.npml < 2 or min(cfg.nz, cfg.nx) - 2 * cfg.npml < L + 1:
        raise ValueError(
            f"boundary strips of depth {L} need npml >= 2 and a physical "
            f"grid of at least {L + 1} cells a side; got {cfg.nz}x{cfg.nx} "
            f"with npml {cfg.npml}")


def _extract_strips(a, cfg: SimConfig):
    """(S, nz, nx) field -> (S, strip_len) strips."""
    L, z0, z1, x0, x1 = _strip_bounds(cfg)
    S = a.shape[0]
    return torch.cat([a[:, z0:z0 + L, :].reshape(S, -1),
                      a[:, z1:z1 + L, :].reshape(S, -1),
                      a[:, :, x0:x0 + L].reshape(S, -1),
                      a[:, :, x1:x1 + L].reshape(S, -1)], dim=1)


def _inject_strips(a, s, cfg: SimConfig):
    """Overwrite the strips of a (S, nz, nx) field with s (S, strip_len)."""
    L, z0, z1, x0, x1 = _strip_bounds(cfg)
    S, nz, nx = a.shape
    top, bot, left, right = torch.split(s, [L * nx, L * nx, nz * L, nz * L],
                                        dim=1)
    a = a.clone()
    a[:, z0:z0 + L, :] = top.reshape(S, L, nx)
    a[:, z1:z1 + L, :] = bot.reshape(S, L, nx)
    a[:, :, x0:x0 + L] = left.reshape(S, nz, L)
    a[:, :, x1:x1 + L] = right.reshape(S, nz, L)
    return a


def _save_bnd(f: Fields, cfg: SimConfig):
    """(S, 5, strip_len): the strips of the 5 fields, in Fields order."""
    return torch.stack([_extract_strips(a, cfg) for a in f], dim=1)


def _reverse_step(f: Fields, mat: MatFields, mask_i, bnd, amp,
                  geom: ShotGeom, cfg: SimConfig) -> Fields:
    """The fields one step back, from those after the step, the strips
    `bnd` (S, 5, strip_len) saved before it and its source sample amp (S,)
    (libCUFD.cu:553-582 ordering)."""
    f = _velocity_reverse(f, mat, mask_i, cfg)
    f = f._replace(vz=_inject_strips(f.vz, bnd[:, 0], cfg),
                   vx=_inject_strips(f.vx, bnd[:, 1], cfg))
    szz, sxx = _add_source(f.szz, f.sxx, amp, geom, cfg, sign=-1.0)
    f = _stress_reverse(f._replace(szz=szz, sxx=sxx), mat, mask_i, cfg)
    return f._replace(szz=_inject_strips(f.szz, bnd[:, 2], cfg),
                      sxx=_inject_strips(f.sxx, bnd[:, 3], cfg),
                      sxz=_inject_strips(f.sxz, bnd[:, 4], cfg))


# ---------------------------------------------------------------------------
# Forward scan
# ---------------------------------------------------------------------------

def _forward(cfg: SimConfig, lam, mu, rho, stf, geom: ShotGeom,
             save_bnd: bool = False):
    """All shots of `geom` over nt-1 steps: data (S, 4, R, nt), sample 0
    zero (recording index it+1, libCUFD.cu:310).  With save_bnd, returns
    (data, final Fields, strips (S, nt-1, 5, strip_len)), the strips of
    step it taken before that step (libCUFD.cu:272)."""
    dtype, device = lam.dtype, lam.device
    S, R = geom.rec_z.shape
    mat = material_fields(lam, mu, rho)
    cp, mask_f = _consts(cfg, device=device, dtype=dtype)
    state = zero_state((S, cfg.nz, cfg.nx), device=device, dtype=dtype)
    data = torch.zeros((S, N_CHANNELS, R, cfg.nt), device=device,
                       dtype=dtype)
    if save_bnd:
        check_strip_grid(cfg)
        strips = torch.empty((S, cfg.nt - 1, N_FIELDS, strip_len(cfg)),
                             device=device, dtype=dtype)
    for it in range(cfg.nt - 1):
        if save_bnd:
            strips[:, it] = _save_bnd(state.f, cfg)
        state, rec = elastic_step(state, mat, stf[:, it], geom, cp, mask_f,
                                  cfg)
        data[..., it + 1] = rec
    if save_bnd:
        return data, state.f, strips
    return data


def reconstruct(cfg: SimConfig, lam, mu, rho, stf, geom: ShotGeom,
                final: Fields, strips) -> Fields:
    """The reconstruction alone: the fields rebuilt back to t=0 from the
    final fields and the strips (the primal half of `adjoint`)."""
    mat = material_fields(lam, mu, rho)
    mask_i = _interior_mask(cfg, device=lam.device, dtype=lam.dtype)
    f = final
    for it in reversed(range(cfg.nt - 1)):
        f = _reverse_step(f, mat, mask_i, strips[:, it], stf[:, it], geom,
                          cfg)
    return f


def material_grads(cfg: SimConfig, lam, mu, rho, gmat: MatFields):
    """Gradients of (lam, mu, rho) from those of the material fields,
    kept inside the interior only, where the reconstruction is exact
    (as the reference's imaging conditions, el_stress.cu:92)."""
    mz, mx = _interior_mask(cfg, device=lam.device, dtype=lam.dtype)
    with torch.enable_grad():
        prims = tuple(a.detach().requires_grad_() for a in (lam, mu, rho))
        mat = material_fields(*prims)
        return torch.autograd.grad(tuple(mat), prims,
                                   tuple(g * (mz * mx) for g in gmat))


def adjoint(cfg: SimConfig, lam, mu, rho, stf, geom: ShotGeom, final: Fields,
            strips, d_data):
    """The boundary-saving adjoint over all shots: from the final fields,
    the strips and the data cotangent d_data (S, 4, R, nt), returns
    (gmat, d_stf, f0): the gradients of the material fields summed over
    shots and over the whole grid (not yet masked), d_stf (S, nt) and the
    fields reconstructed back to t=0.  Each step reconstructs state_t and
    takes autograd of elastic_step there with zero CPML memory."""
    dtype, device = lam.dtype, lam.device
    shape = (stf.shape[0], cfg.nz, cfg.nx)
    mat = MatFields(*(m.detach() for m in material_fields(lam, mu, rho)))
    cp, mask_f = _consts(cfg, device=device, dtype=dtype)
    mask_i = _interior_mask(cfg, device=device, dtype=dtype)
    zero_psi = zero_state(shape, device=device, dtype=dtype).psi
    adj = zero_state(shape, device=device, dtype=dtype)
    gmat = [torch.zeros_like(m) for m in mat]
    d_stf = torch.zeros_like(stf)
    f = Fields(*(a.detach() for a in final))
    for it in reversed(range(cfg.nt - 1)):
        amp = stf[:, it].detach()
        f = _reverse_step(f, mat, mask_i, strips[:, it], amp, geom, cfg)
        with torch.enable_grad():
            ins = tuple(a.clone().requires_grad_()
                        for a in (*f, *zero_psi, *mat, amp))
            state_t = State(Fields(*ins[:5]), Psi(*ins[5:13]))
            out, rec = elastic_step(state_t, MatFields(*ins[13:18]), ins[18],
                                    geom, cp, mask_f, cfg)
            grads = torch.autograd.grad(
                (*out.f, *out.psi, rec), ins,
                (*adj.f, *adj.psi, d_data[..., it + 1]))
        adj = State(Fields(*grads[:5]), Psi(*grads[5:13]))
        for g, d in zip(gmat, grads[13:18]):
            g += d
        d_stf[:, it] = grads[18]
    return MatFields(*gmat), d_stf, f


class _Propagate(torch.autograd.Function):
    """The forward with strip saving, and the boundary-saving adjoint as
    its backward: the counterpart of the JAX engine's custom_vjp."""

    @staticmethod
    def forward(ctx, cfg, geom, lam, mu, rho, stf):
        if not any(ctx.needs_input_grad[2:]):
            return _forward(cfg, lam, mu, rho, stf, geom)
        data, final, strips = _forward(cfg, lam, mu, rho, stf, geom,
                                       save_bnd=True)
        ctx.cfg, ctx.geom = cfg, geom
        ctx.save_for_backward(lam, mu, rho, stf, strips, *final)
        return data

    @staticmethod
    def backward(ctx, d_data):
        lam, mu, rho, stf, strips, *final = ctx.saved_tensors
        gmat, d_stf, _ = adjoint(ctx.cfg, lam, mu, rho, stf, ctx.geom,
                                 Fields(*final), strips, d_data)
        d_lam, d_mu, d_rho = material_grads(ctx.cfg, lam, mu, rho, gmat)
        return None, None, d_lam, d_mu, d_rho, d_stf


def propagate(cfg: SimConfig, lam, mu, rho, stf, geom: ShotGeom):
    """Simulate one shot (stf (nt,), geom fields without the shot axis);
    returns seismograms shaped (4, n_rec, nt), channels (pr, vx, vz, ett).
    Differentiable in lam, mu, rho, stf by the boundary-saving adjoint."""
    one = ShotGeom(*(None if g is None else g[None] for g in geom))
    return propagate_shots(cfg, lam, mu, rho, stf[None], one)[0]


def propagate_shots(cfg: SimConfig, lam, mu, rho, stf, geoms: ShotGeom):
    """All shots at once: stf (S, nt), geoms fields lead with S; returns
    (S, 4, n_rec, nt).  Replaces the shot loop of `Torch_Fwi.cpp:71-95`.
    Differentiable by the boundary-saving adjoint."""
    return _Propagate.apply(cfg, geoms, lam, mu, rho, stf)


def propagate_ad(cfg: SimConfig, lam, mu, rho, stf, geoms: ShotGeom):
    """The same forward differentiated by plain autograd through every step
    (keeps the whole history): the oracle of the boundary-saving adjoint.
    stf (S, nt), geoms fields lead with S."""
    return _forward(cfg, lam, mu, rho, stf, geoms)
