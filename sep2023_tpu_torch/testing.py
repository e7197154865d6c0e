"""Problem builders and comparisons shared by the GPU tests and
chip_smoke.py, so both hold the CUDA kernels against their plain versions
on the same cases with the same tolerances."""
from __future__ import annotations

import numpy as np
import torch

from sep2023_tpu_torch import das, models
from sep2023_tpu_torch.config import SimConfig, ricker
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine
from sep2023_tpu_torch.ops.misfit import residual

# row_problem arguments of the kernel-vs-plain cases that chip_smoke.py and
# tests/test_torch_cuda.py both run (forward, strips, gradient).
ROW_CASES = {
    "small exx": (44, 60, 10, 260, 2, 38, "exx"),
    "small ezz": (44, 60, 10, 260, 2, 38, "ezz"),
    "reference shape nt=301": (101, 201, 32, 301, 19, 40, "exx"),
}

# fiber_problem arguments of the point-receiver cases that chip_smoke.py
# and tests/test_torch_cuda.py both run: (das_channel, spacing, dt, f0).
# The receivers of each are built in `_fiber_receivers`.
FIBER_CASES = {
    "arc weighted": ("weighted", 10.0, 0.001, 15.0),
    "column ezz": ("ezz", 20.0, 0.002, 10.0),
    "duplicate points exx": ("exx", 20.0, 0.002, 10.0),
}

# Acoustic kernel-vs-plain cases that chip_smoke.py and
# tests/test_torch_cuda.py both run, on the 44x60 grid (npml 10, nt=260,
# 2 shots): physical-grid (rec_z, rec_x) of a row, of points that visit a
# cell several times, and of a column.
AC_CASES = {
    "row": (np.full(40, 38), np.arange(10, 50)),
    "duplicate points": (np.array([30] * 16 + [31] * 6),
                         np.array(list(range(14, 26)) + [25] * 4
                                  + list(range(18, 24)))),
    "column": (np.arange(8, 34), np.full(26, 48)),
}
# The acoustic gradients are kept on the tight interior [npml+2, n-3-npml]
# (acoustic._consts); kernel and plain are compared on it shrunk by
# GRAD_MARGIN, for the same reason as the elastic ones.
AC_INTERIOR = 2

# Kernel vs plain, float32 both.  Forward data: per channel, relative to the
# channel max (the JAX package's Pallas-vs-XLA bound); strips and final
# fields: per field, relative to the field max.
FWD_TOL = 2e-5
# Gradients: relative to the max abs of each gradient, the JAX package's
# Pallas-vs-XLA gradient bound (tests/test_pallas_engine.py:166), on the
# interior shrunk by GRAD_MARGIN cells as there: at the interior's edge the
# kernel takes the velocity phase's stencils of the carried (exact) stresses,
# as the Pallas kernel does, where the plain version's autograd of the step
# recomputes them from zero CPML memory.
GRAD_TOL = 5e-4
GRAD_MARGIN = 2
# Adjoint identity <d, J s> = <J^T d, s> in the source wavelet (float32),
# the bound of test_pallas_adjoint_dot_product.
DOT_TOL = 5e-5
# The kernel's f32 reconstruction residual may be at most this multiple of
# the plain f32 version's on the same final fields and strips.
RECON_RATIO = 10.0


def _problem(nz, nx, npml, nt, n_shots, das_channel, dh, dt, f0, device):
    """Anomaly model on an nz x nx physical grid, shots along z=1, float32:
    (cfg, args) with args the padded-grid inputs of
    forward_cuda_plan/forward_plain after the plan or the survey."""
    cfg = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=dh, dx=dh,
                    nt=nt, dt=dt, f0=f0, npml=npml, das_channel=das_channel)
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    t = lambda a: torch.as_tensor(pad_model_np(a, npml), device=device
                                  ).to(torch.float32)
    lam, mu, rho = Medium(t(vp), t(vs), t(rho)).to_lame()
    stf = torch.as_tensor(ricker(f0, nt, dt), device=device
                          ).to(torch.float32).expand(n_shots, nt).contiguous()
    src_x = np.linspace(10, nx - 10, n_shots).astype(int) + npml
    return cfg, (lam.contiguous(), mu.contiguous(), rho.contiguous(), stf,
                 np.full(n_shots, 1 + npml), src_x, np.ones(n_shots))


def row_problem(nz, nx, npml, nt, n_shots, rec_z, das_channel="exx", *,
                device):
    """`_problem` at 20 m, 2 ms, 10 Hz with one receiver row at rec_z
    (physical grid): (cfg, rs, args)."""
    cfg, args = _problem(nz, nx, npml, nt, n_shots, das_channel, 20.0, 0.002,
                         10.0, device)
    return cfg, cuda_engine.RowSurvey(rec_z + npml, 10 + npml, nx - 20), args


def _fiber_receivers(name, dh):
    """Physical-grid (rec_z, rec_x, das_w or None) of a FIBER_CASES case."""
    if name == "arc weighted":
        # two arc cables of 21 points 20 m apart: neighbouring points share
        # cells, and the second cable's samples overlap the first's
        cables = [das.arc_fiber(80.0, 2.0 / np.pi, center=(cx, 200.0, 0.0))
                  for cx in (260.0, 280.0)]
        parts = [das.cable_to_receivers(c, dh, dh) for c in cables]
        return tuple(np.concatenate(p) for p in zip(*parts))
    if name == "column ezz":
        return np.arange(8, 34), np.full(26, 48), None
    if name == "duplicate points exx":
        # a row spread that visits its last cell 4 more times and a second
        # row below it (the JAX package's duplicate-lane cables)
        rec_z = np.array([30] * 16 + [31] * 6)
        rec_x = np.array(list(range(14, 26)) + [25] * 4
                         + list(range(18, 24)))
        return rec_z, rec_x, None
    raise KeyError(name)


def fiber_problem(name, *, device):
    """A FIBER_CASES case on the 44x60 grid (npml 10, nt=260, 2 shots):
    (cfg, FiberSurvey, args)."""
    das_channel, dh, dt, f0 = FIBER_CASES[name]
    npml = 10
    cfg, args = _problem(44, 60, npml, 260, 2, das_channel, dh, dt, f0,
                         device)
    rec_z, rec_x, das_w = _fiber_receivers(name, dh)
    return cfg, cuda_engine.make_fiber_survey(rec_z + npml, rec_x + npml,
                                              das_w), args


def acoustic_args(args):
    """The acoustic inputs (lam = rho vp^2, rho, stf, src_z, src_x) of the
    elastic inputs `args` of `_problem`: the same vp and rho."""
    lam, mu, rho, stf, src_z, src_x, _ = args
    return (lam + 2.0 * mu).contiguous(), rho, stf, src_z, src_x


def ac_row_problem(nz, nx, npml, nt, n_shots, rec_z, *, device):
    """`row_problem` for the acoustic kernels: (cfg, RowSurvey, args) with
    args the inputs of forward_cuda_acoustic_plan after the plan."""
    cfg, rs, args = row_problem(nz, nx, npml, nt, n_shots, rec_z,
                                device=device)
    return cfg, rs, acoustic_args(args)


def ac_fiber_problem(rec_z, rec_x, *, device):
    """Point receivers at physical-grid (rec_z, rec_x) on the 44x60 grid
    (npml 10, nt=260, 2 shots): (cfg, FiberSurvey, args)."""
    npml = 10
    cfg, args = _problem(44, 60, npml, 260, 2, "exx", 20.0, 0.002, 10.0,
                         device)
    return cfg, cuda_engine.make_fiber_survey(rec_z + npml, rec_x + npml), \
        acoustic_args(args)


def ac_problem(name, *, device):
    """An AC_CASES case: the row as a RowSurvey, the others as points."""
    rec_z, rec_x = AC_CASES[name]
    if name == "row":
        return ac_row_problem(44, 60, 10, 260, 2, int(rec_z[0]),
                              device=device)
    return ac_fiber_problem(rec_z, rec_x, device=device)


def ac_perturbed_cotangent(cfg, rs, args, syn):
    """The data cotangent of 0.5 sum((obs - syn)^2) over the three acoustic
    channels, sample 0 zeroed, against the data of the model with lam raised
    by 3% (forward_cuda_acoustic_plan on the tensors' device)."""
    lam, rho, stf, src_z, src_x = args
    obs = cuda_acoustic.forward_cuda_acoustic_plan(
        cuda_engine.plan_for(cfg, rs), (lam * 1.03).contiguous(), rho, stf,
        src_z, src_x)
    return -residual(obs, syn)


def perturbed_cotangent(cfg, rs, args, syn):
    """The data cotangent of the default L2 misfit on ett (0.5 sum((obs -
    syn)^2), sample 0 zeroed: -(obs - syn) on ett) against the data of the
    model with lam raised by 3% (forward_cuda_plan on the tensors'
    device)."""
    lam, mu, rho, stf, src_z, src_x, rxz = args
    obs = cuda_engine.forward_cuda_plan(
        cuda_engine.plan_for(cfg, rs), (lam * 1.03).contiguous(), mu, rho,
        stf, src_z, src_x, rxz)
    d = torch.zeros_like(syn)
    d[:, 3] = -residual(obs, syn)[:, 3]
    return d


def max_rel(out, ref) -> float:
    """max |out - ref| / max |ref|; 0 when both are all zero."""
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    return err / scale if scale > 0 else err


def strip_errors(out, ref):
    """Kernel vs plain forward with strip saving, out and ref each (data,
    strips, final): (max_rel per data channel, per strip field, per final
    field), each relative to that channel's or field's max."""
    (d, s, f), (dr, sr, fr) = out, ref
    return ([max_rel(d[:, c], dr[:, c]) for c in range(d.shape[1])],
            [max_rel(s[:, :, k], sr[:, :, k]) for k in range(s.shape[2])],
            [max_rel(f[k], fr[k]) for k in range(f.shape[0])])


def reconstruction_residual(cfg: SimConfig, f0, data) -> float:
    """The stresses reconstructed back to t=0 should be zero: their max
    |value| over the interior, relative to the peak |pr| recorded (the
    measure of the JAX package's tests/test_reconstruction.py).  Of the
    acoustic fields (3, S, nz, nx) the pressure."""
    n = cfg.npml
    stress = f0[2:] if f0.shape[0] == 5 else f0[:1]
    inner = stress[:, :, n:cfg.nz - n, n:cfg.nx - n]
    return float(inner.abs().max() / data[:, 0].abs().max())


def grad_errors(out, ref, cfg: SimConfig, interior: int = 0):
    """max_rel of each gradient of (d_lam, d_mu, d_rho, d_stf) or of the
    acoustic (d_lam, d_rho, d_stf): the model gradients on the interior
    (which starts `interior` cells inside the PML: AC_INTERIOR for the
    acoustic ones) shrunk by GRAD_MARGIN, d_stf whole."""
    m = cfg.npml + interior + GRAD_MARGIN
    sl = (slice(m, cfg.nz - m), slice(m, cfg.nx - m))
    return [max_rel(a[sl], b[sl]) for a, b in zip(out[:-1], ref[:-1])] + \
        [max_rel(out[-1], ref[-1])]


def adjoint_gap(cfg, rs, args, seed=7):
    """<d, J s> against <J^T d, s> through cuda_engine.propagate_cuda_plan
    (with the 5 acoustic inputs of `acoustic_args`:
    cuda_acoustic.propagate_cuda_acoustic_plan), with J the (linear) map
    from the source wavelets to the data and s, d random from `seed`:
    returns (lhs, rhs, |lhs - rhs| / |lhs|)."""
    is_acoustic = len(args) == 5
    stf = args[2] if is_acoustic else args[3]
    rng = np.random.default_rng(seed)
    dev = stf.device
    s = torch.as_tensor(rng.standard_normal(stf.shape), device=dev
                        ).to(torch.float32).requires_grad_()
    d = torch.as_tensor(rng.standard_normal(
        (stf.shape[0], 3 if is_acoustic else 4, rs.n_rec, cfg.nt)),
        device=dev).to(torch.float32)
    plan = cuda_engine.plan_for(cfg, rs)
    if is_acoustic:
        data = cuda_acoustic.propagate_cuda_acoustic_plan(
            plan, *args[:2], s, *args[3:])
    else:
        data = cuda_engine.propagate_cuda_plan(plan, *args[:3], s, *args[4:])
    lhs = float((d.double() * data.detach().double()).sum())
    (g,) = torch.autograd.grad(data, s, d)
    rhs = float((g.double() * s.detach().double()).sum())
    return lhs, rhs, abs(lhs - rhs) / abs(lhs)
