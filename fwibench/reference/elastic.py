"""The plain reference of the elastic engine: a 2-D velocity-stress
propagator with CPML, its receiver-row recording and its boundary-saving
adjoint, in plain PyTorch on any device and dtype.

A frozen copy of the port's plain propagator (its stencils, CPML profiles,
material averaging, forward, reconstruction and adjoint), cut to what the
benchmark's configurations use: a receiver row or any list of points, ett
as the x difference of vx (`exx`).  It imports nothing of the port, so a
later change to the port cannot move the yardstick.  The gradient is the
boundary-saving adjoint the port computes, not autograd through the
forward: the two differ on the 2-cell ring at the interior's edge, and the
port's answer is the former.

Shapes: every field is (S, nz, nx) on the padded grid; a dtype other than
float32 (the control's bfloat16) runs the same arithmetic in that dtype.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

C1 = 9.0 / 8.0   # O(4) staggered-grid coefficients
C2 = 1.0 / 24.0
SRC_SCALE = 1500.0 ** 2
N_FIELDS = 5


@dataclasses.dataclass(frozen=True)
class Grid:
    """A padded grid and its time axis (nz, nx include 2 npml)."""

    nz: int
    nx: int
    dz: float
    dx: float
    nt: int
    dt: float
    f0: float
    npml: int = 32
    n_bnd_layers: int = 5
    src_scale: float = SRC_SCALE


class Fields(NamedTuple):
    vz: torch.Tensor
    vx: torch.Tensor
    szz: torch.Tensor
    sxx: torch.Tensor
    sxz: torch.Tensor


class Psi(NamedTuple):
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


class Geom(NamedTuple):
    """S shots on the padded grid: src_z, src_x (S,) int64, rxz (S,),
    rec_z, rec_x (S, R) int64."""

    src_z: torch.Tensor
    src_x: torch.Tensor
    rxz: torch.Tensor
    rec_z: torch.Tensor
    rec_x: torch.Tensor


class MatFields(NamedTuple):
    lam: torch.Tensor
    lp2m: torch.Tensor
    ave_mu: torch.Tensor
    byc_a: torch.Tensor
    byc_b: torch.Tensor


class Cpml(NamedTuple):
    ikz: torch.Tensor
    az: torch.Tensor
    bz: torch.Tensor
    ikz_h: torch.Tensor
    az_h: torch.Tensor
    bz_h: torch.Tensor
    ikx: torch.Tensor
    ax: torch.Tensor
    bx: torch.Tensor
    ikx_h: torch.Tensor
    ax_h: torch.Tensor
    bx_h: torch.Tensor


# -- stencils -----------------------------------------------------------------

def dz_minus(f):
    p = F.pad(f, (0, 0, 2, 2))
    return (C1 * (p[..., 2:-2, :] - p[..., 1:-3, :])
            - C2 * (p[..., 3:-1, :] - p[..., :-4, :]))


def dz_plus(f):
    p = F.pad(f, (0, 0, 2, 2))
    return (C1 * (p[..., 3:-1, :] - p[..., 2:-2, :])
            - C2 * (p[..., 4:, :] - p[..., 1:-3, :]))


def dx_minus(f):
    p = F.pad(f, (2, 2))
    return (C1 * (p[..., 2:-2] - p[..., 1:-3])
            - C2 * (p[..., 3:-1] - p[..., :-4]))


def dx_plus(f):
    p = F.pad(f, (2, 2))
    return (C1 * (p[..., 3:-1] - p[..., 2:-2])
            - C2 * (p[..., 4:] - p[..., 1:-3]))


def band_mask(n_z, n_x, lo_z, hi_z, lo_x, hi_x, *, device, dtype):
    """Rows [lo_z, hi_z] and columns [lo_x, hi_x], inclusive, as a
    (nz, 1) x (1, nx) pair of 0/1 vectors."""
    iz = torch.arange(n_z, device=device)
    ix = torch.arange(n_x, device=device)
    return (((iz >= lo_z) & (iz <= hi_z)).to(dtype).reshape(-1, 1),
            ((ix >= lo_x) & (ix <= hi_x)).to(dtype).reshape(1, -1))


# -- CPML ---------------------------------------------------------------------

def _profiles_1d(n, npml, dh, dt, f0, half=False, cp_ref=3000.0,
                 npower=8.0, rcoef=8e-4, k_max=2.0):
    thickness = npml * dh
    d0 = -(npower + 1.0) * cp_ref * np.log(rcoef) / (2.0 * thickness)
    alpha_max = 2.0 * np.pi * (f0 / 2.0)
    i = np.arange(n, dtype=np.float64)
    off = 0.5 if half else 0.0
    depth = np.maximum((npml - i - off) * dh, (npml - n + i + off) * dh)
    inside = depth >= 0.0
    s = np.where(inside, depth / thickness, 0.0)
    damp = np.where(inside, d0 * (0.25 * s + 0.75 * s ** npower), 0.0)
    K = np.where(inside, 1.0 + (k_max - 1.0) * s ** npower, 1.0)
    alpha = np.where(inside, np.maximum(alpha_max * (1.0 - s), 0.0), 0.0)
    b = np.exp(-(damp / K + alpha) * dt)
    active = np.abs(damp) > 1e-6
    denom = np.where(active, K * (damp + K * alpha), 1.0)
    a = np.where(active, damp * (b - 1.0) / denom, 0.0)
    return K, a, b


def cpml(g: Grid, *, device, dtype) -> Cpml:
    """The division-free CPML profiles, built in float64 and cast:
    psi <- b psi + a' D, d_eff = D ik + psi."""
    kz, az, bz = _profiles_1d(g.nz, g.npml, g.dz, g.dt, g.f0)
    kzh, azh, bzh = _profiles_1d(g.nz, g.npml, g.dz, g.dt, g.f0, half=True)
    kx, ax, bx = _profiles_1d(g.nx, g.npml, g.dx, g.dt, g.f0)
    kxh, axh, bxh = _profiles_1d(g.nx, g.npml, g.dx, g.dt, g.f0, half=True)

    def col(p):
        return torch.as_tensor(p.reshape(-1, 1)).to(device, dtype)

    def row(p):
        return torch.as_tensor(p.reshape(1, -1)).to(device, dtype)

    return Cpml(col(1.0 / (kz * g.dz)), col(az / g.dz), col(bz),
                col(1.0 / (kzh * g.dz)), col(azh / g.dz), col(bzh),
                row(1.0 / (kx * g.dx)), row(ax / g.dx), row(bx),
                row(1.0 / (kxh * g.dx)), row(axh / g.dx), row(bxh))


# -- material fields ----------------------------------------------------------

def _up(a):      # a[z+1, x], edge replicated
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)


def _left(a):    # a[z, x+1], edge replicated
    return torch.cat([a[..., :, 1:], a[..., :, -1:]], dim=-1)


def material_fields(lam, mu, rho) -> MatFields:
    """Harmonic 4-point mu average (0 where any of the four is 0) and the
    arithmetic buoyancy averages; differentiable."""
    mu_b, mu_c = _up(mu), _left(mu)
    mu_d = _left(mu_b)
    nonzero = (mu != 0) & (mu_b != 0) & (mu_c != 0) & (mu_d != 0)
    safe = [torch.where(nonzero, m, 1.0) for m in (mu, mu_b, mu_c, mu_d)]
    hm = 4.0 / (1.0 / safe[0] + 1.0 / safe[1] + 1.0 / safe[2]
                + 1.0 / safe[3])
    return MatFields(lam=lam, lp2m=lam + 2.0 * mu,
                     ave_mu=torch.where(nonzero, hm, 0.0),
                     byc_a=2.0 / (_up(rho) + rho),
                     byc_b=2.0 / (_left(rho) + rho))


# -- forward step -------------------------------------------------------------

def _stress_update(f, psi, mat, cp, mask, g):
    mz, mx = mask
    dt = g.dt
    d_vz = dz_minus(f.vz)
    p_vz_dz = cp.bz * psi.vz_dz + cp.az * d_vz
    dvz = d_vz * cp.ikz + p_vz_dz
    d_vx = dx_minus(f.vx)
    p_vx_dx = cp.bx * psi.vx_dx + cp.ax * d_vx
    dvx = d_vx * cp.ikx + p_vx_dx
    szz = f.szz + (mz * mx) * ((mat.lp2m * dvz + mat.lam * dvx) * dt)
    sxx = f.sxx + (mz * mx) * ((mat.lam * dvz + mat.lp2m * dvx) * dt)
    d_vxz = dz_plus(f.vx)
    p_vx_dz = cp.bz_h * psi.vx_dz + cp.az_h * d_vxz
    dvxz = d_vxz * cp.ikz_h + p_vx_dz
    d_vzx = dx_plus(f.vz)
    p_vz_dx = cp.bx_h * psi.vz_dx + cp.ax_h * d_vzx
    dvzx = d_vzx * cp.ikx_h + p_vz_dx
    sxz = f.sxz + (mz * mx) * (mat.ave_mu * (dvxz + dvzx) * dt)
    return (szz, sxx, sxz), (p_vz_dz, p_vx_dx, p_vx_dz, p_vz_dx)


def _velocity_update(f, psi, mat, cp, mask, g):
    mz, mx = mask
    dt = g.dt
    d_szz = dz_plus(f.szz)
    p_szz_dz = cp.bz_h * psi.szz_dz + cp.az_h * d_szz
    dszz = d_szz * cp.ikz_h + p_szz_dz
    d_sxzx = dx_minus(f.sxz)
    p_sxz_dx = cp.bx * psi.sxz_dx + cp.ax * d_sxzx
    dsxzx = d_sxzx * cp.ikx + p_sxz_dx
    vz = f.vz + (mz * mx) * ((dszz + dsxzx) * mat.byc_a * dt)
    d_sxzz = dz_minus(f.sxz)
    p_sxz_dz = cp.bz * psi.sxz_dz + cp.az * d_sxzz
    dsxzz = d_sxzz * cp.ikz + p_sxz_dz
    d_sxx = dx_plus(f.sxx)
    p_sxx_dx = cp.bx_h * psi.sxx_dx + cp.ax_h * d_sxx
    dsxx = d_sxx * cp.ikx_h + p_sxx_dx
    vx = f.vx + (mz * mx) * ((dsxzz + dsxx) * mat.byc_b * dt)
    return (vz, vx), (p_szz_dz, p_sxz_dx, p_sxz_dz, p_sxx_dx)


def _record(f: Fields, geom: Geom):
    """(S, 4, R): pr = szz + sxx, vx, vz, and ett = vx[x] - vx[x-1]
    (not divided by dx)."""
    s = torch.arange(geom.rec_z.shape[0], device=geom.rec_z.device)[:, None]
    rz, rx = geom.rec_z, geom.rec_x
    return torch.stack([f.szz[s, rz, rx] + f.sxx[s, rz, rx],
                        f.vx[s, rz, rx], f.vz[s, rz, rx],
                        f.vx[s, rz, rx] - f.vx[s, rz, rx - 1]], dim=1)


def _add_source(szz, sxx, amp, geom: Geom, g: Grid, sign=1.0):
    s = sign * g.src_scale * g.dt * amp
    idx = (torch.arange(amp.shape[0], device=amp.device), geom.src_z,
           geom.src_x)
    return (szz.index_put(idx, s, accumulate=True),
            sxx.index_put(idx, geom.rxz * s, accumulate=True))


def step(state: State, mat, amp, geom, cp, mask_f, g):
    """One leapfrog step: stress, source, velocity, record."""
    f, psi = state
    (szz, sxx, sxz), (p1, p2, p3, p4) = _stress_update(f, psi, mat, cp,
                                                       mask_f, g)
    szz, sxx = _add_source(szz, sxx, amp, geom, g)
    f2 = Fields(f.vz, f.vx, szz, sxx, sxz)
    psi2 = Psi(p1, p2, p3, p4, psi.szz_dz, psi.sxz_dx, psi.sxz_dz,
               psi.sxx_dx)
    (vz, vx), (p5, p6, p7, p8) = _velocity_update(f2, psi2, mat, cp, mask_f,
                                                  g)
    f3 = Fields(vz, vx, szz, sxx, sxz)
    return State(f3, Psi(p1, p2, p3, p4, p5, p6, p7, p8)), _record(f3, geom)


def _zero_state(shape, *, device, dtype) -> State:
    def z():
        return torch.zeros(shape, device=device, dtype=dtype)
    return State(Fields(*(z() for _ in range(5))),
                 Psi(*(z() for _ in range(8))))


def _masks(g: Grid, *, device, dtype):
    """The forward update mask [2, n-3] and the interior [npml,
    n-1-npml] where the reconstruction updates and gradients are kept."""
    fwd = band_mask(g.nz, g.nx, 2, g.nz - 3, 2, g.nx - 3, device=device,
                    dtype=dtype)
    inner = band_mask(g.nz, g.nx, g.npml, g.nz - 1 - g.npml, g.npml,
                      g.nx - 1 - g.npml, device=device, dtype=dtype)
    return fwd, inner


# -- reconstruction and strips ------------------------------------------------

def _velocity_reverse(f: Fields, mat, mask_i, g: Grid):
    mz, mx = mask_i
    idz, idx = 1.0 / g.dz, 1.0 / g.dx
    dvz = dz_plus(f.szz) * idz + dx_minus(f.sxz) * idx
    dvx = dz_minus(f.sxz) * idz + dx_plus(f.sxx) * idx
    return f._replace(vz=f.vz - (mz * mx) * (dvz * mat.byc_a * g.dt),
                      vx=f.vx - (mz * mx) * (dvx * mat.byc_b * g.dt))


def _stress_reverse(f: Fields, mat, mask_i, g: Grid):
    mz, mx = mask_i
    dt = g.dt
    idz, idx = 1.0 / g.dz, 1.0 / g.dx
    dvz_dz = dz_minus(f.vz) * idz
    dvx_dx = dx_minus(f.vx) * idx
    szz = f.szz - (mz * mx) * ((mat.lp2m * dvz_dz + mat.lam * dvx_dx) * dt)
    sxx = f.sxx - (mz * mx) * ((mat.lam * dvz_dz + mat.lp2m * dvx_dx) * dt)
    shear = dz_plus(f.vx) * idz + dx_plus(f.vz) * idx
    sxz = f.sxz - (mz * mx) * (mat.ave_mu * shear * dt)
    return f._replace(szz=szz, sxx=sxx, sxz=sxz)


def strip_len(g: Grid) -> int:
    """One field's strips: top and bottom (L, nx), left and right (nz, L)."""
    return 2 * g.n_bnd_layers * (g.nz + g.nx)


def _strip_bounds(g: Grid):
    return (g.n_bnd_layers, g.npml - 2, g.nz - g.npml - 3, g.npml - 2,
            g.nx - g.npml - 3)


def _extract(a, g: Grid):
    L, z0, z1, x0, x1 = _strip_bounds(g)
    S = a.shape[0]
    return torch.cat([a[:, z0:z0 + L, :].reshape(S, -1),
                      a[:, z1:z1 + L, :].reshape(S, -1),
                      a[:, :, x0:x0 + L].reshape(S, -1),
                      a[:, :, x1:x1 + L].reshape(S, -1)], dim=1)


def _inject(a, s, g: Grid):
    L, z0, z1, x0, x1 = _strip_bounds(g)
    S, nz, nx = a.shape
    top, bot, left, right = torch.split(s, [L * nx, L * nx, nz * L, nz * L],
                                        dim=1)
    a = a.clone()
    a[:, z0:z0 + L, :] = top.reshape(S, L, nx)
    a[:, z1:z1 + L, :] = bot.reshape(S, L, nx)
    a[:, :, x0:x0 + L] = left.reshape(S, nz, L)
    a[:, :, x1:x1 + L] = right.reshape(S, nz, L)
    return a


def _reverse_step(f: Fields, mat, mask_i, bnd, amp, geom, g) -> Fields:
    f = _velocity_reverse(f, mat, mask_i, g)
    f = f._replace(vz=_inject(f.vz, bnd[:, 0], g),
                   vx=_inject(f.vx, bnd[:, 1], g))
    szz, sxx = _add_source(f.szz, f.sxx, amp, geom, g, sign=-1.0)
    f = _stress_reverse(f._replace(szz=szz, sxx=sxx), mat, mask_i, g)
    return f._replace(szz=_inject(f.szz, bnd[:, 2], g),
                      sxx=_inject(f.sxx, bnd[:, 3], g),
                      sxz=_inject(f.sxz, bnd[:, 4], g))


# -- forward and adjoint ------------------------------------------------------

@torch.no_grad()
def forward(g: Grid, lam, mu, rho, stf, geom: Geom, save_bnd=False):
    """Data (S, 4, R, nt) of all shots, sample 0 zero; with save_bnd also
    the final fields and the strips (S, nt-1, 5, strip_len) saved before
    each step."""
    dtype, device = lam.dtype, lam.device
    S, R = geom.rec_z.shape
    mat = material_fields(lam, mu, rho)
    cp = cpml(g, device=device, dtype=dtype)
    mask_f, _ = _masks(g, device=device, dtype=dtype)
    state = _zero_state((S, g.nz, g.nx), device=device, dtype=dtype)
    data = torch.zeros((S, 4, R, g.nt), device=device, dtype=dtype)
    if save_bnd:
        strips = torch.empty((S, g.nt - 1, N_FIELDS, strip_len(g)),
                             device=device, dtype=dtype)
    for it in range(g.nt - 1):
        if save_bnd:
            strips[:, it] = torch.stack([_extract(a, g) for a in state.f],
                                        dim=1)
        state, rec = step(state, mat, stf[:, it], geom, cp, mask_f, g)
        data[..., it + 1] = rec
    if save_bnd:
        return data, state.f, strips
    return data


@torch.no_grad()
def adjoint(g: Grid, lam, mu, rho, stf, geom: Geom, final: Fields, strips,
            d_data):
    """(d_lam, d_mu, d_rho) of all shots by the boundary-saving adjoint:
    reconstruct each step's state from the final fields and the strips,
    take autograd of `step` there with zero CPML memory, and keep the
    material gradients inside the interior."""
    dtype, device = lam.dtype, lam.device
    shape = (stf.shape[0], g.nz, g.nx)
    mat = MatFields(*(m.detach() for m in material_fields(lam, mu, rho)))
    cp = cpml(g, device=device, dtype=dtype)
    mask_f, mask_i = _masks(g, device=device, dtype=dtype)
    zero_psi = _zero_state(shape, device=device, dtype=dtype).psi
    adj = _zero_state(shape, device=device, dtype=dtype)
    gmat = [torch.zeros_like(m) for m in mat]
    f = Fields(*(a.detach() for a in final))
    for it in reversed(range(g.nt - 1)):
        amp = stf[:, it].detach()
        f = _reverse_step(f, mat, mask_i, strips[:, it], amp, geom, g)
        with torch.enable_grad():
            ins = tuple(a.clone().requires_grad_()
                        for a in (*f, *zero_psi, *mat))
            out, rec = step(State(Fields(*ins[:5]), Psi(*ins[5:13])),
                            MatFields(*ins[13:18]), amp, geom, cp, mask_f,
                            g)
            grads = torch.autograd.grad(
                (*out.f, *out.psi, rec), ins,
                (*adj.f, *adj.psi, d_data[..., it + 1]))
        adj = State(Fields(*grads[:5]), Psi(*grads[5:13]))
        for acc, d in zip(gmat, grads[13:18]):
            acc += d
    mz, mx = mask_i
    with torch.enable_grad():
        prims = tuple(a.detach().requires_grad_() for a in (lam, mu, rho))
        return torch.autograd.grad(tuple(material_fields(*prims)), prims,
                                   tuple(d * (mz * mx) for d in gmat))


class _Propagate(torch.autograd.Function):
    """The forward with strips; its backward is the boundary-saving
    adjoint (gradients of lam, mu, rho; none of the wavelets)."""

    @staticmethod
    def forward(ctx, g, geom, stf, lam, mu, rho):
        data, final, strips = forward(g, lam, mu, rho, stf, geom,
                                      save_bnd=True)
        ctx.g, ctx.geom = g, geom
        ctx.save_for_backward(lam, mu, rho, stf, strips, *final)
        return data

    @staticmethod
    def backward(ctx, d_data):
        lam, mu, rho, stf, strips, *final = ctx.saved_tensors
        grads = adjoint(ctx.g, lam, mu, rho, stf, ctx.geom, Fields(*final),
                        strips, d_data)
        return (None, None, None, *grads)


def propagate(g: Grid, lam, mu, rho, stf, geom: Geom):
    """Data (S, 4, R, nt), differentiable in lam, mu, rho by the
    boundary-saving adjoint."""
    return _Propagate.apply(g, geom, stf, lam, mu, rho)
