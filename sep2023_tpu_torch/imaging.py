"""Imaging utilities: gradient chain rules between parameterizations and
RTM-style velocity images.

PyTorch counterpart of `sep2023_tpu/imaging.py`.  Replaces:
  - the (lam, mu, rho) -> (vp, vs, rho) gradient chain rule the reference
    hand-codes in `Ops/FWI/propagator.py:210-216`
  - the zero-lag cross-correlation Vp imaging kernel
    (`image_vel.cu:26-27`: gCp += -2 Cp rho (dvz+dvx) sigma_adj dt), which is
    exactly the Vp-parameterized FWI gradient, obtained here by autograd
    through lam = rho(vp^2 - 2 vs^2), mu = rho vs^2.
All of it runs on the tensors' own device.
"""
from __future__ import annotations

import torch

from sep2023_tpu_torch import acoustic, propagator
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.medium import material_fields
from sep2023_tpu_torch.ops import misfit as mf
from sep2023_tpu_torch.ops.cuda_engine import count_plain


def lame_grads_to_velocity(g_lam, g_mu, g_rho, vp, vs, rho):
    """Chain rule (dJ/dlam, dJ/dmu, dJ/drho) -> (dJ/dvp, dJ/dvs, dJ/drho)
    for lam = rho(vp^2-2vs^2), mu = rho vs^2 (propagator.py:210-216)."""
    g_vp = 2.0 * rho * vp * g_lam
    g_vs = -4.0 * rho * vs * g_lam + 2.0 * rho * vs * g_mu
    g_rho2 = (vp ** 2 - 2.0 * vs ** 2) * g_lam + vs ** 2 * g_mu + g_rho
    return g_vp, g_vs, g_rho2


def rtm_image(cfg: SimConfig, vp, vs, rho, stf, geom, residual_data,
              channels=("ett",)):
    """Reverse-time-migration image of one shot (stf (nt,), geom a ShotGeom
    without the shot axis): the Vp sensitivity kernel of an L2 misfit
    against `residual_data` (4, R, nt) treated as the observed field, the
    differentiable equivalent of the reference's image_vel path
    (`main.cu:322+`, `image_vel.cu`)."""
    with torch.enable_grad():
        vp_ = vp.detach().requires_grad_()
        lam = (vp_ ** 2 - 2.0 * vs ** 2) * rho
        mu = vs ** 2 * rho
        syn = propagator.propagate(cfg, lam, mu, rho, stf, geom)
        loss = mf.l2_misfit(residual_data, syn, channels=channels)
        (image,) = torch.autograd.grad(loss, vp_)
    return image


def rtm_image_time(cfg: SimConfig, vp, rho, stf, geom, residual_data,
                   return_illum: bool = False):
    """Time-derivative RTM imaging condition on the acoustic pressure field
    (`image_vel_time.cu:25-37`): I = sum_t -2/vp (p_{t+1}-p_t) p_adj.  See
    acoustic.rtm_image_time (geom is an acoustic.AcGeom);
    return_illum=True also returns the per-cell source energy sum_t p_t^2."""
    return acoustic.rtm_image_time(cfg, vp, rho, stf, geom, residual_data,
                                   return_illum=return_illum)


@torch.no_grad()
def source_illumination(cfg: SimConfig, lam, mu, rho, stf, geoms):
    """Per-cell source-wavefield energy sum_t (szz+sxx)^2 of every shot
    (stf (S, nt), geoms a ShotGeom with the shot axis): (S, nz, nx), the
    illumination denominator for the zero-lag Vp image (conditioning
    image_vel.cu:26-27's kernel), masked to the interior.  One eager forward
    of `propagator.elastic_step`, on the tensors' own device: the plain
    version of `cuda_engine.illumination_cuda_plan`, and counted in its
    PLAIN_CALLS.  The `rtm` command sums it over shots as it sums the
    image."""
    count_plain("source_illumination")
    dtype, device = lam.dtype, lam.device
    mat = material_fields(lam, mu, rho)
    cp, mask_f = propagator._consts(cfg, device=device, dtype=dtype)
    shape = (stf.shape[0], cfg.nz, cfg.nx)
    state = propagator.zero_state(shape, device=device, dtype=dtype)
    ill = torch.zeros(shape, device=device, dtype=dtype)
    for it in range(cfg.nt - 1):
        state, _ = propagator.elastic_step(state, mat, stf[:, it], geoms, cp,
                                           mask_f, cfg)
        pr = state.f.szz + state.f.sxx
        ill += pr * pr
    mz, mx = propagator._interior_mask(cfg, device=device, dtype=dtype)
    return ill * (mz * mx)


def illumination_compensate(image, illum, eps: float = 1e-3):
    """Source-illumination compensation: divide the stacked image per cell
    by the accumulated source-wavefield energy with a stabilized
    denominator, balancing deep (weakly illuminated) reflectors against
    shallow ones.  `illum` comes from `source_illumination` (elastic) or
    `rtm_image_time(..., return_illum=True)` (acoustic), summed over shots
    like the image itself."""
    return image / (illum + eps * illum.max() + 1e-30)


def normalize_image(image, eps: float = 1e-3):
    """Scalar RMS rescale of an image (display normalization only, not
    illumination compensation; use `illumination_compensate` for that)."""
    scale = torch.sqrt(torch.mean(image ** 2))
    return image / (image.abs().max() * eps + scale + 1e-30)
