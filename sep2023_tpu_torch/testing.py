"""Problem builders and comparisons shared by the GPU tests and
chip_smoke.py, so both hold the CUDA kernels against their plain versions
on the same cases with the same tolerances."""
from __future__ import annotations

import numpy as np
import torch

from sep2023_tpu_torch import models
from sep2023_tpu_torch.config import SimConfig, ricker
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.ops.misfit import residual

# row_problem arguments of the kernel-vs-plain cases that chip_smoke.py and
# tests/test_torch_cuda.py both run (forward, strips, gradient).
ROW_CASES = {
    "small exx": (44, 60, 10, 260, 2, 38, "exx"),
    "small ezz": (44, 60, 10, 260, 2, 38, "ezz"),
    "reference shape nt=301": (101, 201, 32, 301, 19, 40, "exx"),
}

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


def row_problem(nz, nx, npml, nt, n_shots, rec_z, das_channel="exx", *,
                device):
    """Anomaly model on an nz x nx physical grid, shots along z=1, one
    receiver row at rec_z (physical grid), float32: (cfg, rs, args) with
    args the padded-grid inputs of forward_cuda/forward_plain after rs."""
    cfg = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0,
                    nt=nt, dt=0.002, f0=10.0, npml=npml,
                    das_channel=das_channel)
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    t = lambda a: torch.as_tensor(pad_model_np(a, npml), device=device
                                  ).to(torch.float32)
    lam, mu, rho = Medium(t(vp), t(vs), t(rho)).to_lame()
    stf = torch.as_tensor(ricker(10.0, nt, 0.002), device=device
                          ).to(torch.float32).expand(n_shots, nt).contiguous()
    src_x = np.linspace(10, nx - 10, n_shots).astype(int) + npml
    rs = cuda_engine.RowSurvey(rec_z + npml, 10 + npml, nx - 20)
    return cfg, rs, (lam.contiguous(), mu.contiguous(), rho.contiguous(),
                     stf, np.full(n_shots, 1 + npml), src_x,
                     np.ones(n_shots))


def perturbed_cotangent(cfg, rs, args, syn):
    """The data cotangent of the default L2 misfit on ett (0.5 sum((obs -
    syn)^2), sample 0 zeroed: -(obs - syn) on ett) against the data of the
    model with lam raised by 3% (forward_cuda on the tensors' device)."""
    lam, mu, rho, stf, src_z, src_x, rxz = args
    obs = cuda_engine.forward_cuda(cfg, rs, (lam * 1.03).contiguous(), mu,
                                   rho, stf, src_z, src_x, rxz)
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
    return ([max_rel(d[:, c], dr[:, c]) for c in range(4)],
            [max_rel(s[:, :, k], sr[:, :, k]) for k in range(5)],
            [max_rel(f[k], fr[k]) for k in range(5)])


def reconstruction_residual(cfg: SimConfig, f0, data) -> float:
    """The stresses reconstructed back to t=0 should be zero: their max
    |value| over the interior, relative to the peak |pr| recorded (the
    measure of the JAX package's tests/test_reconstruction.py)."""
    n = cfg.npml
    inner = f0[2:, :, n:cfg.nz - n, n:cfg.nx - n]
    return float(inner.abs().max() / data[:, 0].abs().max())


def grad_errors(out, ref, cfg: SimConfig):
    """max_rel of each of (d_lam, d_mu, d_rho, d_stf); the model gradients
    on the interior shrunk by GRAD_MARGIN."""
    m = cfg.npml + GRAD_MARGIN
    sl = (slice(m, cfg.nz - m), slice(m, cfg.nx - m))
    return [max_rel(a[sl], b[sl]) for a, b in zip(out[:3], ref[:3])] + \
        [max_rel(out[3], ref[3])]


def adjoint_gap(cfg, rs, args, seed=7):
    """<d, J s> against <J^T d, s> through cuda_engine.propagate_cuda, with
    J the (linear) map from the source wavelets to the data and s, d random
    from `seed`: returns (lhs, rhs, |lhs - rhs| / |lhs|)."""
    lam, mu, rho, stf, src_z, src_x, rxz = args
    rng = np.random.default_rng(seed)
    dev = lam.device
    s = torch.as_tensor(rng.standard_normal(stf.shape), device=dev
                        ).to(torch.float32).requires_grad_()
    d = torch.as_tensor(rng.standard_normal(
        (stf.shape[0], 4, rs.n_rec, cfg.nt)), device=dev).to(torch.float32)
    data = cuda_engine.propagate_cuda(cfg, rs, lam, mu, rho, s, src_z,
                                      src_x, rxz)
    lhs = float((d.double() * data.detach().double()).sum())
    (g,) = torch.autograd.grad(data, s, d)
    rhs = float((g.double() * s.detach().double()).sum())
    return lhs, rhs, abs(lhs - rhs) / abs(lhs)
