"""Elastic medium containers and staggered-grid material averaging.

PyTorch counterpart of `sep2023_tpu/medium.py` (`Model.cu:85-87`,
`utilities.cu:109-152`, `fwi_utils.py:11-44`).  All material fields live on
the PADDED (nz, nx) grid; z is axis 0, x is axis 1.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch


class MatFields(NamedTuple):
    """Precomputed per-cell material fields consumed by the time step.

    lam     : lambda at integer points               (sxx/szz node)
    lp2m    : lambda + 2 mu at integer points
    ave_mu  : harmonic 4-point average of mu         (sxz node)
    byc_a   : 2 / (rho[z+1,x] + rho[z,x])            (vz node buoyancy)
    byc_b   : 2 / (rho[z,x+1] + rho[z,x])            (vx node buoyancy)
    """

    lam: torch.Tensor
    lp2m: torch.Tensor
    ave_mu: torch.Tensor
    byc_a: torch.Tensor
    byc_b: torch.Tensor


def _shift_up(a):  # a[z+1, x] with edge replicate
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)


def _shift_left(a):  # a[z, x+1] with edge replicate
    return torch.cat([a[..., :, 1:], a[..., :, -1:]], dim=-1)


def material_fields(lam, mu, rho) -> MatFields:
    """(lam, mu, rho) -> staggered fields: the harmonic 4-point mu average,
    zero wherever one of the four mu is zero (fluid), and the arithmetic
    buoyancy averages.  Differentiable with autograd."""
    mu_b = _shift_up(mu)        # mu[z+1, x]
    mu_c = _shift_left(mu)      # mu[z, x+1]
    mu_d = _shift_left(mu_b)    # mu[z+1, x+1]
    nonzero = (mu != 0) & (mu_b != 0) & (mu_c != 0) & (mu_d != 0)
    safe = torch.where(nonzero, mu, 1.0)
    safe_b = torch.where(nonzero, mu_b, 1.0)
    safe_c = torch.where(nonzero, mu_c, 1.0)
    safe_d = torch.where(nonzero, mu_d, 1.0)
    hm = 4.0 / (1.0 / safe + 1.0 / safe_b + 1.0 / safe_c + 1.0 / safe_d)
    ave_mu = torch.where(nonzero, hm, 0.0)

    byc_a = 2.0 / (_shift_up(rho) + rho)
    byc_b = 2.0 / (_shift_left(rho) + rho)
    return MatFields(lam=lam, lp2m=lam + 2.0 * mu, ave_mu=ave_mu,
                     byc_a=byc_a, byc_b=byc_b)


class Medium(NamedTuple):
    """Velocity-density parameterization on the padded grid."""

    vp: torch.Tensor
    vs: torch.Tensor
    rho: torch.Tensor

    @property
    def lam(self):
        return (self.vp ** 2 - 2.0 * self.vs ** 2) * self.rho

    @property
    def mu(self):
        return self.vs ** 2 * self.rho

    def to_lame(self):
        return self.lam, self.mu, self.rho

    @staticmethod
    def from_lame(lam, mu, rho) -> "Medium":
        vp = torch.sqrt((lam + 2.0 * mu) / rho)
        vs = torch.sqrt(mu / rho)
        return Medium(vp=vp, vs=vs, rho=rho)


def check_lambda(lam) -> float:
    """Warn when the first Lamé parameter goes negative anywhere
    (vp² < 2·vs²): the simulation stays defined but it almost always means
    a bad model (the reference prints the same warning, `Model.cu:37-40`).
    Returns min(lam)."""
    lam_min = float(lam.min())
    if lam_min < 0:
        warnings.warn(
            f"negative Lame lambda (min {lam_min:.3e}): vp^2 < 2*vs^2 "
            "somewhere in the model (Model.cu:37-40 prints the same "
            "warning)", RuntimeWarning, stacklevel=2)
    return lam_min


def pad_model(arr, npml: int):
    """Replicate-pad a physical (nz, nx) model by the PML collar on all 4
    sides (nPad-free analogue of `fwi_utils.py:11-27`); differentiable."""
    nz, nx = arr.shape[-2:]
    iz = torch.arange(-npml, nz + npml, device=arr.device).clamp(0, nz - 1)
    ix = torch.arange(-npml, nx + npml, device=arr.device).clamp(0, nx - 1)
    return arr[..., iz, :][..., ix]


def pad_model_np(arr: np.ndarray, npml: int) -> np.ndarray:
    return np.pad(arr, ((npml, npml), (npml, npml)), mode="edge")
