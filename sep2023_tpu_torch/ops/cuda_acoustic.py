"""Acoustic engine on the GPU: the hand-written CUDA kernels
`csrc/acoustic_fwd.cu` (the 3-field forward, optionally saving the boundary
strips) and `csrc/acoustic_bwd.cu` (the boundary-saving adjoint and its
imaging variant), and their plain PyTorch versions, built on `acoustic.py`.

Counterpart of the acoustic half of `sep2023_tpu/ops/pallas_engine.py`:
`forward_cuda_acoustic_plan` of `forward_pallas_acoustic`/`_ac_run_forward`
(K5), `backward_cuda_acoustic_plan` of `_ac_run_backward` (K6),
`propagate_cuda_acoustic_plan`, a `torch.autograd.Function`, of
`propagate_pallas_acoustic` with `_pa_fwd`/`_pa_bwd` and of
`propagate_pallas_acoustic_auto`.  There is no fused/streamed choice: the
kernels keep all state in device memory, so one pair runs every grid size
(it is the counterpart of the streamed acoustic pair of `pallas_stream.py`,
K7/K8, too).  `rtm_image_time_cuda_plan` is `acoustic.rtm_image_time`'s
route on the card: a forward with strips, then `image_cuda_acoustic_plan`,
the backward kernel's reverse loop with the image and illumination
accumulators in place of the material gradients.

Every entry takes a `cuda_engine.FastPlan`: a `RowSurvey` or a
`FiberSurvey` (its points; weights and the config's das_channel play no
part, the acoustic data has no ett channel).

Data is (S, 3, n_rec, nt) float32, channels (pr, vx, vz), receivers in the
caller's order.  The strips are (S, nt-1, 3, strip_len) in the flat layout
of `propagator._extract_strips`, the final fields (3, S, nz, nx) in AcFields
order; kernels and plain versions share both.

The wrappers take their plain versions only for tensors that lie on the
CPU.  On CUDA tensors they launch the kernels or raise.  `LAUNCHES_AC` and
`LAUNCHES_AC_BWD` count the kernel launches (`LAUNCHES_AC_STRIPS` the
forward's with strip saving, `LAUNCHES_AC_IMG` the backward's made as the
imaging variant) and `cuda_engine.PLAIN_CALLS` the calls of each plain
version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from sep2023_tpu_torch import acoustic, propagator
from sep2023_tpu_torch.acoustic import AcFields, AcGeom
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.ops.cuda_engine import (PLAIN_CALLS, FastPlan,
                                               FiberSurvey, _check_model,
                                               _check_tensor, _load,
                                               _profiles, _ptr, _raise_on,
                                               _row_args)

# Kernel launches made by forward_cuda_acoustic_plan: 3 per time step
# (pressure, velocity, record), with or without strip saving, row or point
# receivers.
LAUNCHES_AC = 0
# The part of LAUNCHES_AC made with strip saving (the gradient's and the
# image's forward).
LAUNCHES_AC_STRIPS = 0
# Kernel launches made by backward_cuda_acoustic_plan,
# reconstruct_cuda_acoustic_plan and rtm_image_time_cuda_plan: 2 a step
# (velocity, pressure) and 1 shot sum; with a FiberSurvey 3 per time step
# (the point injection first) and 1 shot sum.
LAUNCHES_AC_BWD = 0
# The part of LAUNCHES_AC_BWD made as the imaging variant.
LAUNCHES_AC_IMG = 0

N_STATE_PLANES = 7   # 3 fields + 4 CPML psi
N_WORK_PLANES = 11   # 3 adjoint fields + 4 adjoint psi + 4 stencil cotangents
N_GRAD_PLANES = 3    # per-shot gradients of (lam, byc_a, byc_b)
N_IMAGE_PLANES = 2   # per-shot image and illumination (the imaging variant)
N_CHANNELS = len(acoustic.AC_CHANNELS)


def launches_forward_acoustic(cfg: SimConfig) -> int:
    """Launches of one forward_cuda_acoustic_plan call on the card: 3 a
    step."""
    return 3 * (cfg.nt - 1)


def launches_backward_acoustic(cfg: SimConfig, rs) -> int:
    """Launches of one acoustic backward (or imaging) call on the card: 2 a
    step for a receiver row, 3 for point receivers, and the shot sum."""
    per_step = 3 if isinstance(rs, FiberSurvey) else 2
    return per_step * (cfg.nt - 1) + 1


def _check_inputs(plan: FastPlan, lam, rho, stf, src_z, src_x):
    """Validate everything the kernels would otherwise read out of bounds;
    returns the plan's (src_z, src_x) tensors on lam's device."""
    S = _check_model(plan, (("lam", lam), ("rho", rho)), stf)
    return plan.sources(lam.device, S, src_z, src_x,
                        np.ones(S, np.float32))[:2]


def _check_residuals(plan: FastPlan, lam, stf, final, strips, d_data):
    """The backward's extra inputs: the forward's final fields and strips
    and the data cotangent, each float32, contiguous, on lam's device."""
    cfg = plan.cfg
    propagator.check_strip_grid(cfg)
    S = stf.shape[0]
    _check_tensor("final", final, (3, S, cfg.nz, cfg.nx), lam.device)
    _check_tensor("strips", strips, (S, cfg.nt - 1, 3,
                                     propagator.strip_len(cfg)), lam.device)
    _check_tensor("d_data", d_data, (S, N_CHANNELS, plan.rs.n_rec, cfg.nt),
                  lam.device)


def _geoms(cfg, rs, src_z, src_x, device) -> AcGeom:
    """The survey as the plain propagator's AcGeom, the same receivers for
    every shot."""
    S = torch.as_tensor(src_z).reshape(-1).shape[0]
    g = cuda_engine._geoms(cfg, rs, src_z, src_x, np.ones(S), device,
                           torch.float32)
    return AcGeom(g.src_z, g.src_x, g.rec_z, g.rec_x)


def forward_plain_acoustic(cfg: SimConfig, rs, lam, rho, stf, src_z, src_x):
    """The plain PyTorch version of the acoustic forward kernel:
    acoustic.propagate_acoustic_shots on the survey, on the tensors' own
    device."""
    PLAIN_CALLS["forward_plain_acoustic"] += 1
    geoms = _geoms(cfg, rs, src_z, src_x, lam.device)
    return acoustic.propagate_acoustic_shots(cfg, lam, rho, stf, geoms)


@torch.no_grad()
def forward_plain_acoustic_strips(cfg: SimConfig, rs, lam, rho, stf,
                                  src_z, src_x):
    """The plain version of the forward kernel with strip saving: (data,
    strips (S, nt-1, 3, strip_len), final fields (3, S, nz, nx))."""
    PLAIN_CALLS["forward_plain_acoustic_strips"] += 1
    geoms = _geoms(cfg, rs, src_z, src_x, lam.device)
    data, final, strips = acoustic._forward(cfg, lam, rho, stf, geoms,
                                            save_bnd=True)
    return data, strips, torch.stack(tuple(final))


@torch.no_grad()
def backward_plain_acoustic(cfg: SimConfig, rs, lam, rho, stf, src_z, src_x,
                            final, strips, d_data):
    """The plain version of the backward kernel, acoustic.adjoint on the
    survey: (d_lam, d_rho, d_stf), the material gradients kept inside the
    tight interior and chained through the buoyancies."""
    PLAIN_CALLS["backward_plain_acoustic"] += 1
    geoms = _geoms(cfg, rs, src_z, src_x, lam.device)
    gmat, d_stf, _ = acoustic.adjoint(cfg, lam, rho, stf, geoms,
                                      AcFields(*final), strips, d_data)
    return (*acoustic.acoustic_grads(cfg, rho, gmat), d_stf)


@torch.no_grad()
def reconstruct_plain_acoustic(cfg: SimConfig, rs, lam, rho, stf, src_z,
                               src_x, final, strips):
    """The plain reconstruction alone (acoustic.reconstruct): the fields
    (3, S, nz, nx) rebuilt back to t=0 from the final fields and strips."""
    PLAIN_CALLS["reconstruct_plain_acoustic"] += 1
    geoms = _geoms(cfg, rs, src_z, src_x, lam.device)
    f0 = acoustic.reconstruct(cfg, lam, rho, stf, geoms, AcFields(*final),
                              strips)
    return torch.stack(tuple(f0))


@torch.no_grad()
def rtm_image_time_plain(cfg: SimConfig, rs, vp, rho, stf, src_z, src_x,
                         residual):
    """The plain version of rtm_image_time_cuda_plan,
    acoustic.rtm_image_time_shots on the survey: (image, illumination), each
    (S, nz, nx)."""
    PLAIN_CALLS["rtm_image_time_plain"] += 1
    geoms = _geoms(cfg, rs, src_z, src_x, vp.device)
    return acoustic.rtm_image_time_shots(cfg, vp, rho, stf, geoms, residual)


def _materials(lam, rho):
    """(3, nz, nx): lam and the two staggered buoyancies."""
    return torch.stack((lam, *acoustic._buoyancies(rho))).contiguous()


def forward_cuda_acoustic_plan(plan: FastPlan, lam, rho, stf, src_z, src_x,
                               save_strips: bool = False):
    """All-shots acoustic forward under a FastPlan (the counterpart of
    `forward_pallas_acoustic`).  lam (= rho vp^2) and rho (nz, nx) and stf
    (S, nt), float32 and contiguous; src_z/src_x (S,) on the padded grid.
    Returns data (S, 3, n_rec, nt) float32 on the tensors' device; with
    save_strips, (data, strips (S, nt-1, 3, strip_len), final fields
    (3, S, nz, nx)).

    CPU tensors run the plain versions; CUDA tensors run the kernel, at any
    grid size."""
    global LAUNCHES_AC, LAUNCHES_AC_STRIPS
    cfg, rs = plan.cfg, plan.rs
    src = _check_inputs(plan, lam, rho, stf, src_z, src_x)
    if save_strips:
        propagator.check_strip_grid(cfg)
    if lam.device.type == "cpu":
        plain = (forward_plain_acoustic_strips if save_strips
                 else forward_plain_acoustic)
        return plain(cfg, rs, lam, rho, stf, *src)
    device = lam.device
    lib = _load(device)
    S = stf.shape[0]
    with torch.cuda.device(device):
        mats = _materials(lam, rho)
        prof_z, prof_x = _profiles(cfg, device)
        rec = plan.receivers(device, acoustic=True)
        rec_z, rec_x = (None, None) if rec is None else rec[:2]
        state = torch.zeros((N_STATE_PLANES, S, cfg.nz, cfg.nx),
                            device=device, dtype=torch.float32)
        data = torch.zeros((S, N_CHANNELS, rs.n_rec, cfg.nt), device=device,
                           dtype=torch.float32)
        strips = (torch.empty((S, cfg.nt - 1, 3, propagator.strip_len(cfg)),
                              device=device, dtype=torch.float32)
                  if save_strips else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.acoustic_forward(
            mats.data_ptr(), prof_z.data_ptr(), prof_x.data_ptr(),
            stf.data_ptr(), *(t.data_ptr() for t in src),
            _ptr(rec_z), _ptr(rec_x),
            state.data_ptr(), data.data_ptr(), _ptr(strips),
            S, cfg.nz, cfg.nx, cfg.nt, *_row_args(rs), cfg.npml,
            cfg.n_bnd_layers, ctypes.c_float(cfg.dt),
            ctypes.c_float(cfg.src_scale * cfg.dt), stream)
    _raise_on(lib, err, "acoustic_forward")
    LAUNCHES_AC += launches_forward_acoustic(cfg)
    if save_strips:
        LAUNCHES_AC_STRIPS += launches_forward_acoustic(cfg)
        return data, strips, state[:3]
    return data


def _backward_kernel(plan: FastPlan, lam, rho, stf, src, final, strips,
                     d_data, img_coef=None):
    """Launch acoustic_backward on CUDA tensors: (per-shot accumulator
    planes (S, n, nz, nx), their sum over shots (n, nz, nx), d_stf (S, nt),
    fields reconstructed at t=0 (3, S, nz, nx)), with n = 3, the gradients
    of (lam, byc_a, byc_b), or, with img_coef (nz, nx), n = 2, the image and
    the illumination."""
    global LAUNCHES_AC_BWD, LAUNCHES_AC_IMG
    cfg, rs = plan.cfg, plan.rs
    device = lam.device
    lib = _load(device)
    S = stf.shape[0]
    n_acc = N_GRAD_PLANES if img_coef is None else N_IMAGE_PLANES
    with torch.cuda.device(device):
        mats = _materials(lam, rho)
        prof_z, prof_x = _profiles(cfg, device)
        rec = plan.receivers(device, acoustic=True)
        table = (None,) * 6 if rec is None else rec[3]
        n_inj = 0 if rec is None else table[1].shape[0]
        fields = final.clone()
        zeros = lambda *shape: torch.zeros(shape, device=device,
                                           dtype=torch.float32)
        work = zeros(N_WORK_PLANES, S, cfg.nz, cfg.nx)
        acc = zeros(S, n_acc, cfg.nz, cfg.nx)
        acc_sum = torch.empty((n_acc, cfg.nz, cfg.nx), device=device,
                              dtype=torch.float32)
        d_stf = zeros(S, cfg.nt)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.acoustic_backward(
            mats.data_ptr(), prof_z.data_ptr(), prof_x.data_ptr(),
            stf.data_ptr(), *(t.data_ptr() for t in src),
            strips.data_ptr(), d_data.data_ptr(), *(_ptr(t) for t in table),
            _ptr(img_coef), fields.data_ptr(), work.data_ptr(),
            acc.data_ptr(), acc_sum.data_ptr(), d_stf.data_ptr(),
            S, cfg.nz, cfg.nx, cfg.nt, *_row_args(rs), n_inj, cfg.npml,
            cfg.n_bnd_layers, ctypes.c_float(cfg.dt),
            ctypes.c_float(cfg.src_scale * cfg.dt), stream)
    _raise_on(lib, err, "acoustic_backward")
    LAUNCHES_AC_BWD += launches_backward_acoustic(cfg, rs)
    if img_coef is not None:
        LAUNCHES_AC_IMG += launches_backward_acoustic(cfg, rs)
    return acc, acc_sum, d_stf, fields


def backward_cuda_acoustic_plan(plan: FastPlan, lam, rho, stf, src_z, src_x,
                                final, strips, d_data):
    """The boundary-saving adjoint of all shots under a FastPlan.  final
    (3, S, nz, nx) and strips come from
    forward_cuda_acoustic_plan(save_strips=True); d_data (S, 3, n_rec, nt)
    is the data cotangent.  Returns (d_lam, d_rho, d_stf): the kernel's
    material-plane gradients kept inside the tight interior and chained
    through the buoyancies by autograd, as _ac_run_backward does.

    CPU tensors run backward_plain_acoustic; CUDA tensors run the kernel,
    at any grid size."""
    src = _check_inputs(plan, lam, rho, stf, src_z, src_x)
    _check_residuals(plan, lam, stf, final, strips, d_data)
    cfg = plan.cfg
    if lam.device.type == "cpu":
        return backward_plain_acoustic(cfg, plan.rs, lam, rho, stf, *src,
                                       final, strips, d_data)
    _, gmat, d_stf, _ = _backward_kernel(plan, lam, rho, stf, src, final,
                                         strips, d_data)
    return (*acoustic.acoustic_grads(cfg, rho, tuple(gmat)), d_stf)


def reconstruct_cuda_acoustic_plan(plan: FastPlan, lam, rho, stf, src_z,
                                   src_x, final, strips):
    """The backward kernel's reconstruction alone, driven with a zero data
    cotangent: the fields (3, S, nz, nx) rebuilt back to t=0.  CUDA tensors
    only; reconstruct_plain_acoustic is its plain version."""
    src = _check_inputs(plan, lam, rho, stf, src_z, src_x)
    d_data = torch.zeros((stf.shape[0], N_CHANNELS, plan.rs.n_rec,
                          plan.cfg.nt), device=lam.device,
                         dtype=torch.float32)
    _check_residuals(plan, lam, stf, final, strips, d_data)
    return _backward_kernel(plan, lam, rho, stf, src, final, strips,
                            d_data)[3]


def image_cuda_acoustic_plan(plan: FastPlan, vp, rho, stf, src_z, src_x,
                             final, strips, residual,
                             sum_shots: bool = False):
    """The imaging variant of the backward kernel alone, CUDA tensors only:
    from the final fields and strips of a forward in the model (vp, rho)
    and the data residual (S, 3, n_rec, nt), the time-derivative image and
    the source illumination, each (S, nz, nx) and masked to the tight
    interior, or, with sum_shots, each (nz, nx), summed over shots in shot
    order.  rtm_image_time_plain is its plain version (with the forward)."""
    cfg = plan.cfg
    lam = (rho * vp ** 2).contiguous()
    src = _check_inputs(plan, lam, rho, stf, src_z, src_x)
    _check_tensor("vp", vp, (cfg.nz, cfg.nx), lam.device)
    _check_residuals(plan, lam, stf, final, strips, residual)
    acc, acc_sum, _, _ = _backward_kernel(
        plan, lam, rho, stf, src, final, strips, residual,
        img_coef=(-2.0 / vp).contiguous())
    mz, mx = acoustic._consts(cfg, device=lam.device, dtype=lam.dtype)[2]
    m = mz * mx
    if sum_shots:
        return acc_sum[0] * m, acc_sum[1] * m
    return acc[:, 0] * m, acc[:, 1] * m


def rtm_image_time_cuda_plan(plan: FastPlan, vp, rho, stf, src_z, src_x,
                             residual, sum_shots: bool = False):
    """Time-derivative RTM image and source illumination of all shots under
    a FastPlan (`acoustic.rtm_image_time` with return_illum, on the card): a
    forward with strip saving in the model (vp, rho), then the backward
    kernel's imaging variant (`image_cuda_acoustic_plan`) with the data
    residual (S, 3, n_rec, nt) as the cotangent.  Returns (image,
    illumination), each (S, nz, nx) and masked to the tight interior, or,
    with sum_shots, each (nz, nx), summed over shots in shot order.

    CPU tensors run rtm_image_time_plain; CUDA tensors run the kernels, at
    any grid size."""
    cfg = plan.cfg
    lam = (rho * vp ** 2).contiguous()
    src = _check_inputs(plan, lam, rho, stf, src_z, src_x)
    _check_tensor("vp", vp, (cfg.nz, cfg.nx), lam.device)
    _check_tensor("residual", residual,
                  (stf.shape[0], N_CHANNELS, plan.rs.n_rec, cfg.nt),
                  lam.device)
    if lam.device.type == "cpu":
        img, ill = rtm_image_time_plain(cfg, plan.rs, vp, rho, stf, *src,
                                        residual)
        return (img.sum(0), ill.sum(0)) if sum_shots else (img, ill)
    _, strips, final = forward_cuda_acoustic_plan(plan, lam, rho, stf,
                                                  src_z, src_x,
                                                  save_strips=True)
    return image_cuda_acoustic_plan(plan, vp, rho, stf, src_z, src_x, final,
                                    strips, residual, sum_shots)


class _PropagateCudaAcoustic(torch.autograd.Function):
    """forward_cuda_acoustic_plan with strip saving, and the backward
    kernel as its backward: the counterpart of propagate_pallas_acoustic's
    custom_vjp (_pa_fwd/_pa_bwd)."""

    @staticmethod
    def forward(ctx, plan, src_z, src_x, lam, rho, stf):
        if not any(ctx.needs_input_grad[3:]):
            return forward_cuda_acoustic_plan(plan, lam, rho, stf, src_z,
                                              src_x)
        data, strips, final = forward_cuda_acoustic_plan(
            plan, lam, rho, stf, src_z, src_x, save_strips=True)
        ctx.args = (plan, src_z, src_x)
        ctx.save_for_backward(lam, rho, stf, final, strips)
        return data

    @staticmethod
    def backward(ctx, d_data):
        plan, src_z, src_x = ctx.args
        lam, rho, stf, final, strips = ctx.saved_tensors
        grads = backward_cuda_acoustic_plan(plan, lam, rho, stf, src_z,
                                            src_x, final, strips,
                                            d_data.contiguous())
        return (None,) * 3 + tuple(grads)


def propagate_cuda_acoustic_plan(plan: FastPlan, lam, rho, stf, src_z,
                                 src_x):
    """Differentiable all-shots acoustic propagator under a FastPlan (the
    counterpart of `propagate_pallas_acoustic` and
    `propagate_pallas_acoustic_auto`): data (S, 3, n_rec, nt), with
    gradients of lam, rho and stf by the boundary-saving adjoint.  float32
    only: CUDA tensors run the kernels, at any grid size, CPU tensors their
    plain versions; anything else raises."""
    if lam.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA kernels compute in float32, not {lam.dtype}; the "
            "plain propagator (acoustic.propagate_acoustic_shots) runs "
            "other dtypes on the CPU")
    return _PropagateCudaAcoustic.apply(plan, src_z, src_x,
                                        lam.contiguous(), rho.contiguous(),
                                        stf.contiguous())
