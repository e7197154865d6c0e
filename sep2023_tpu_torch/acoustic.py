"""2-D acoustic (pressure-velocity) propagator with CPML and a
boundary-saving adjoint: the plain PyTorch version.

PyTorch counterpart of `sep2023_tpu/acoustic.py` (the secondary physics mode
of the reference, `ac_pressure.cu` / `ac_velocity.cu`).  As in
`propagator.py` the shot axis is written out: every field is (S, nz, nx) and
the material planes and profiles broadcast against it.

Scheme (p carried in the reference's d_szz array), pressure first:
  p  += lambda * (Dz+ vz + Dx- vx) * dt        (ac_pressure.cu:30-46)
  p[src] += src_scale * dt * amp
  vz += byc_a * Dz- p * dt                     (ac_velocity.cu, b_z profile)
  vx += byc_b * Dx+ p * dt                     (ac_velocity.cu, b_x_half)
The velocities take the post-source pressure, so the reverse step undoes
them first, with the carried p, and subtracts the source before it undoes
the pressure.  Reconstruction region, where gradients are kept too: the
tight interior [npml+2, n-3-npml] (ac_pressure.cu:56-65).

This is the oracle of the CUDA kernels `csrc/acoustic_fwd.cu` and
`csrc/acoustic_bwd.cu` (ops/cuda_acoustic.py), which share its strip layout:
(S, nt-1, 3, strip_len) in AcFields order, each field's strips flat as
`propagator._extract_strips` lays them out.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sep2023_tpu_torch import cpml as cpml_mod
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.medium import _shift_left, _shift_up
from sep2023_tpu_torch.ops import fd
from sep2023_tpu_torch.propagator import (_extract_strips, _inject_strips,
                                          check_strip_grid, strip_len)


class AcFields(NamedTuple):
    p: torch.Tensor
    vz: torch.Tensor
    vx: torch.Tensor


class AcPsi(NamedTuple):
    vz_dz: torch.Tensor
    vx_dx: torch.Tensor
    p_dz: torch.Tensor
    p_dx: torch.Tensor


class AcState(NamedTuple):
    f: AcFields
    psi: AcPsi


class AcGeom(NamedTuple):
    """Acquisition of S shots (indices already on the padded grid)."""

    src_z: torch.Tensor  # (S,) int64
    src_x: torch.Tensor  # (S,) int64
    rec_z: torch.Tensor  # (S, R) int64
    rec_x: torch.Tensor  # (S, R) int64


AC_CHANNELS = ("pr", "vx", "vz")
AC_N_FIELDS = 3


def _zero_state(shape, *, device, dtype) -> AcState:
    z = lambda: torch.zeros(shape, device=device, dtype=dtype)
    return AcState(AcFields(z(), z(), z()), AcPsi(z(), z(), z(), z()))


def _consts(cfg: SimConfig, *, device, dtype):
    """CPML profiles (scaled form, built in float64 and cast), the forward
    update mask [2, n-3] and the tight interior [npml+2, n-3-npml]."""
    cp = cpml_mod.cpml_scaled(cfg.nz, cfg.nx, cfg.npml, cfg.dz, cfg.dx,
                              cfg.dt, cfg.f0, dtype=np.float64)
    cp = cpml_mod.CpmlScaled(*(torch.as_tensor(p).to(device, dtype)
                               for p in cp))
    mask_f = fd.update_mask(cfg.nz, cfg.nx, 2, cfg.nz - 3, 2, cfg.nx - 3,
                            device=device, dtype=dtype)
    mask_i = fd.update_mask(cfg.nz, cfg.nx, cfg.npml + 2,
                            cfg.nz - 3 - cfg.npml, cfg.npml + 2,
                            cfg.nx - 3 - cfg.npml, device=device, dtype=dtype)
    return cp, mask_f, mask_i


def _buoyancies(rho):
    """(byc_a, byc_b): medium.material_fields' staggered buoyancies."""
    return 2.0 / (_shift_up(rho) + rho), 2.0 / (_shift_left(rho) + rho)


def _shot_index(geom: AcGeom):
    return torch.arange(geom.src_z.shape[0], device=geom.src_z.device)


def ac_step(state: AcState, lam, byc_a, byc_b, amp, geom: AcGeom, cp,
            mask, cfg: SimConfig):
    """One leapfrog step, pressure -> source -> velocities -> record; amp
    is (S,), one sample per shot.  Returns (new state, rec (S, 3, R))."""
    mz, mx = mask
    f, psi = state
    dt = cfg.dt

    # division-free CPML form (cpml.CpmlScaled) on raw stencil differences
    dvz = fd.dz_plus(f.vz)
    p_vz = cp.bz_h * psi.vz_dz + cp.az_h * dvz
    dvz_e = dvz * cp.ikz_h + p_vz
    dvx = fd.dx_minus(f.vx)
    p_vx = cp.bx * psi.vx_dx + cp.ax * dvx
    dvx_e = dvx * cp.ikx + p_vx
    p = f.p + (mz * mx) * (lam * (dvz_e + dvx_e) * dt)
    s = _shot_index(geom)
    p = p.index_put((s, geom.src_z, geom.src_x), cfg.src_scale * dt * amp,
                    accumulate=True)

    dpz = fd.dz_minus(p)
    p_pz = cp.bz * psi.p_dz + cp.az * dpz
    dpz_e = dpz * cp.ikz + p_pz
    vz = f.vz + (mz * mx) * (dpz_e * byc_a * dt)

    dpx = fd.dx_plus(p)
    p_px = cp.bx_h * psi.p_dx + cp.ax_h * dpx
    dpx_e = dpx * cp.ikx_h + p_px
    vx = f.vx + (mz * mx) * (dpx_e * byc_b * dt)

    new = AcState(AcFields(p, vz, vx), AcPsi(p_vz, p_vx, p_pz, p_px))
    sr, rz, rx = s[:, None], geom.rec_z, geom.rec_x
    rec = torch.stack([p[sr, rz, rx], vx[sr, rz, rx], vz[sr, rz, rx]], dim=1)
    return new, rec


def _velocity_reverse(f: AcFields, byc_a, byc_b, mask_i, cfg):
    """Undo the velocity update (which used the post-source p_{t+1}).
    Multiplies by the reciprocal spacing: it matches the forward's interior
    d_eff = D * ik, ik = dtype(1/dh) (cpml.CpmlScaled)."""
    mz, mx = mask_i
    dt = cfg.dt
    idz, idx = 1.0 / cfg.dz, 1.0 / cfg.dx
    vz = f.vz - (mz * mx) * (fd.dz_minus(f.p) * idz * byc_a * dt)
    vx = f.vx - (mz * mx) * (fd.dx_plus(f.p) * idx * byc_b * dt)
    return AcFields(f.p, vz, vx)


def _pressure_reverse(f: AcFields, lam, mask_i, cfg):
    mz, mx = mask_i
    idz, idx = 1.0 / cfg.dz, 1.0 / cfg.dx
    p = f.p - (mz * mx) * (lam * (fd.dz_plus(f.vz) * idz
                                  + fd.dx_minus(f.vx) * idx) * cfg.dt)
    return AcFields(p, f.vz, f.vx)


def _save_bnd(f: AcFields, cfg: SimConfig):
    """(S, 3, strip_len): the strips of the 3 fields, in AcFields order."""
    return torch.stack([_extract_strips(a, cfg) for a in f], dim=1)


def _reverse_step(f: AcFields, lam, byc_a, byc_b, mask_i, bnd, amp,
                  geom: AcGeom, cfg: SimConfig) -> AcFields:
    """The fields one step back, from those after the step, the strips `bnd`
    (S, 3, strip_len) saved before it and its source sample amp (S,)."""
    f = _velocity_reverse(f, byc_a, byc_b, mask_i, cfg)
    f = AcFields(f.p, _inject_strips(f.vz, bnd[:, 1], cfg),
                 _inject_strips(f.vx, bnd[:, 2], cfg))
    p = f.p.index_put((_shot_index(geom), geom.src_z, geom.src_x),
                      -cfg.src_scale * cfg.dt * amp, accumulate=True)
    f = _pressure_reverse(AcFields(p, f.vz, f.vx), lam, mask_i, cfg)
    return AcFields(_inject_strips(f.p, bnd[:, 0], cfg), f.vz, f.vx)


def _forward(cfg: SimConfig, lam, rho, stf, geom: AcGeom,
             save_bnd: bool = False):
    """All shots of `geom` over nt-1 steps: data (S, 3, R, nt), sample 0
    zero.  With save_bnd, returns (data, final AcFields, strips (S, nt-1, 3,
    strip_len)), the strips of step it taken before that step."""
    dtype, device = lam.dtype, lam.device
    S, R = geom.rec_z.shape
    byc_a, byc_b = _buoyancies(rho)
    cp, mask_f, _ = _consts(cfg, device=device, dtype=dtype)
    state = _zero_state((S, cfg.nz, cfg.nx), device=device, dtype=dtype)
    data = torch.zeros((S, len(AC_CHANNELS), R, cfg.nt), device=device,
                       dtype=dtype)
    if save_bnd:
        check_strip_grid(cfg)
        strips = torch.empty((S, cfg.nt - 1, AC_N_FIELDS, strip_len(cfg)),
                             device=device, dtype=dtype)
    for it in range(cfg.nt - 1):
        if save_bnd:
            strips[:, it] = _save_bnd(state.f, cfg)
        state, rec = ac_step(state, lam, byc_a, byc_b, stf[:, it], geom, cp,
                             mask_f, cfg)
        data[..., it + 1] = rec
    if save_bnd:
        return data, state.f, strips
    return data


def reconstruct(cfg: SimConfig, lam, rho, stf, geom: AcGeom,
                final: AcFields, strips) -> AcFields:
    """The reconstruction alone: the fields rebuilt back to t=0 from the
    final fields and the strips (the primal half of `adjoint`)."""
    byc_a, byc_b = _buoyancies(rho)
    _, _, mask_i = _consts(cfg, device=lam.device, dtype=lam.dtype)
    f = final
    for it in reversed(range(cfg.nt - 1)):
        f = _reverse_step(f, lam, byc_a, byc_b, mask_i, strips[:, it],
                          stf[:, it], geom, cfg)
    return f


def _reverse_sweep(cfg: SimConfig, lam, rho, stf, geom: AcGeom,
                   final: AcFields, strips, d_data, visit):
    """The time-reversed loop shared by `adjoint` and `rtm_image_time_shots`:
    each step reconstructs state_t, takes autograd of ac_step there with
    zero CPML memory and calls visit(it, p_tp1, f_t, grads), with grads the
    cotangents of (p, vz, vx, 4 psi, lam, byc_a, byc_b, amp).  Returns the
    fields reconstructed back to t=0."""
    dtype, device = lam.dtype, lam.device
    shape = (stf.shape[0], cfg.nz, cfg.nx)
    lam = lam.detach()
    byc_a, byc_b = (b.detach() for b in _buoyancies(rho))
    cp, mask_f, mask_i = _consts(cfg, device=device, dtype=dtype)
    zero_psi = _zero_state(shape, device=device, dtype=dtype).psi
    adj = _zero_state(shape, device=device, dtype=dtype)
    f = AcFields(*(a.detach() for a in final))
    for it in reversed(range(cfg.nt - 1)):
        amp = stf[:, it].detach()
        p_tp1 = f.p
        f = _reverse_step(f, lam, byc_a, byc_b, mask_i, strips[:, it], amp,
                          geom, cfg)
        with torch.enable_grad():
            ins = tuple(a.clone().requires_grad_()
                        for a in (*f, *zero_psi, lam, byc_a, byc_b, amp))
            out, rec = ac_step(AcState(AcFields(*ins[:3]), AcPsi(*ins[3:7])),
                               ins[7], ins[8], ins[9], ins[10], geom, cp,
                               mask_f, cfg)
            grads = torch.autograd.grad(
                (*out.f, *out.psi, rec), ins,
                (*adj.f, *adj.psi, d_data[..., it + 1]))
        adj = AcState(AcFields(*grads[:3]), AcPsi(*grads[3:7]))
        visit(it, p_tp1, f, grads)
    return f


def adjoint(cfg: SimConfig, lam, rho, stf, geom: AcGeom, final: AcFields,
            strips, d_data):
    """The boundary-saving adjoint over all shots: from the final fields,
    the strips and the data cotangent d_data (S, 3, R, nt), returns
    ((g_lam, g_byc_a, g_byc_b), d_stf, f0): the gradients of the material
    planes summed over shots and over the whole grid (not yet masked),
    d_stf (S, nt) with sample nt-1 zero, and the fields reconstructed back
    to t=0."""
    gmat = [torch.zeros_like(lam) for _ in range(3)]
    d_stf = torch.zeros_like(stf)

    def visit(it, p_tp1, f, grads):
        for g, d in zip(gmat, grads[7:10]):
            g += d
        d_stf[:, it] = grads[10]

    f0 = _reverse_sweep(cfg, lam, rho, stf, geom, final, strips, d_data,
                        visit)
    return tuple(gmat), d_stf, f0


def acoustic_grads(cfg: SimConfig, rho, gmat):
    """(d_lam, d_rho) from the gradients of (lam, byc_a, byc_b): kept inside
    the tight interior only, where the reconstruction is exact, and chained
    through `_buoyancies` to rho."""
    mz, mx = _consts(cfg, device=rho.device, dtype=rho.dtype)[2]
    m = mz * mx
    with torch.enable_grad():
        r = rho.detach().requires_grad_()
        (d_rho,) = torch.autograd.grad(_buoyancies(r), (r,),
                                       (gmat[1] * m, gmat[2] * m))
    return gmat[0] * m, d_rho


class _PropagateAcoustic(torch.autograd.Function):
    """The forward with strip saving, and the boundary-saving adjoint as
    its backward: the counterpart of the JAX engine's custom_vjp."""

    @staticmethod
    def forward(ctx, cfg, geom, lam, rho, stf):
        if not any(ctx.needs_input_grad[2:]):
            return _forward(cfg, lam, rho, stf, geom)
        data, final, strips = _forward(cfg, lam, rho, stf, geom,
                                       save_bnd=True)
        ctx.cfg, ctx.geom = cfg, geom
        ctx.save_for_backward(lam, rho, stf, strips, *final)
        return data

    @staticmethod
    def backward(ctx, d_data):
        lam, rho, stf, strips, *final = ctx.saved_tensors
        gmat, d_stf, _ = adjoint(ctx.cfg, lam, rho, stf, ctx.geom,
                                 AcFields(*final), strips, d_data)
        d_lam, d_rho = acoustic_grads(ctx.cfg, rho, gmat)
        return None, None, d_lam, d_rho, d_stf


def _one_shot(geom: AcGeom) -> AcGeom:
    return AcGeom(*(g[None] for g in geom))


def propagate_acoustic(cfg: SimConfig, lam, rho, stf, geom: AcGeom):
    """Acoustic forward of one shot (stf (nt,), geom fields without the shot
    axis): seismograms (3, n_rec, nt), channels (pr, vx, vz).
    Differentiable in lam (= rho*vp^2), rho, stf by the boundary-saving
    adjoint."""
    return propagate_acoustic_shots(cfg, lam, rho, stf[None],
                                    _one_shot(geom))[0]


def propagate_acoustic_shots(cfg: SimConfig, lam, rho, stf, geoms: AcGeom):
    """All shots at once: stf (S, nt), geoms fields lead with S; returns
    (S, 3, n_rec, nt).  Differentiable by the boundary-saving adjoint."""
    return _PropagateAcoustic.apply(cfg, geoms, lam, rho, stf)


def propagate_acoustic_ad(cfg: SimConfig, lam, rho, stf, geoms: AcGeom):
    """The same forward differentiated by plain autograd through every step
    (keeps the whole history): the oracle of the boundary-saving adjoint.
    stf (S, nt), geoms fields lead with S."""
    return _forward(cfg, lam, rho, stf, geoms)


@torch.no_grad()
def rtm_image_time_shots(cfg: SimConfig, vp, rho, stf, geoms: AcGeom,
                         residual):
    """Time-derivative RTM imaging condition (`image_vel_time.cu:25-37`) of
    all shots: (image, illumination), each (S, nz, nx), masked to the tight
    interior:

        I(z, x)   = sum_t  -2 / vp * (p_{t+1} - p_t) * p_adj_t
        ill(z, x) = sum_t  p_t^2

    accumulated over the time-reversed loop of the acoustic backward pass:
    the forward pressure reconstructed by boundary saving, the adjoint
    pressure propagated by the step's transpose with the data residual
    (S, 3, R, nt) injected at the receivers."""
    lam = rho * vp ** 2
    _, final, strips = _forward(cfg, lam, rho, stf, geoms, save_bnd=True)
    shape = (stf.shape[0], cfg.nz, cfg.nx)
    img = torch.zeros(shape, device=vp.device, dtype=vp.dtype)
    ill = torch.zeros_like(img)

    def visit(it, p_tp1, f, grads):
        img.add_((-2.0 / vp) * (p_tp1 - f.p) * grads[0])
        ill.add_(f.p * f.p)

    _reverse_sweep(cfg, lam, rho, stf, geoms, final, strips, residual, visit)
    mz, mx = _consts(cfg, device=vp.device, dtype=vp.dtype)[2]
    return img * (mz * mx), ill * (mz * mx)


def rtm_image_time(cfg: SimConfig, vp, rho, stf, geom: AcGeom, residual,
                   return_illum: bool = False):
    """`rtm_image_time_shots` of one shot (stf (nt,), geom without the shot
    axis, residual (3, R, nt)): the image on the padded grid; with
    return_illum also the per-cell source-wavefield energy sum_t p_t^2, the
    denominator for `imaging.illumination_compensate`."""
    img, ill = rtm_image_time_shots(cfg, vp, rho, stf[None], _one_shot(geom),
                                    residual[None])
    return (img[0], ill[0]) if return_illum else img[0]
