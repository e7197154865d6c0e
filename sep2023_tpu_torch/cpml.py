"""CPML (convolutional perfectly matched layer) coefficient profiles.

A numpy-only copy of `sep2023_tpu/cpml.py` (the port imports no jax).

Port of the recurrence-coefficient construction in the reference
(`utilities.cu:243-359` cpmlInit, invoked from `Cpml.cu`):

  d0      = -(N+1) * cp_ref * ln(Rcoef) / (2 * L)         L = npml * dh
  damp(s) = d0 * (0.25 s + 0.75 s^N)                      s = depth / L
  K(s)    = 1 + (Kmax - 1) s^N
  alpha(s)= pi f0 (1 - s)                                 (alpha_max = 2*pi*f0/2)
  b       = exp(-(damp/K + alpha) dt)
  a       = damp (b - 1) / (K (damp + K alpha))

with N = 8, Rcoef = 8e-4, Kmax = 2 and a model-independent cp_ref = 3000 m/s
(hard-coded in the reference, `utilities.cu:260`).

Design note: outside the PML, damp = 0, K = 1, alpha = 0, hence
b = 1 and a = 0, so the memory-variable recursion
    psi <- b psi + a d     ;     d_eff = d / K + psi
is the identity (psi stays 0).  We therefore apply the CPML update UNIFORMLY
over the grid — no interior/PML masks or gathers — which is mathematically
identical to the reference's region-gated kernels (`el_stress.cu:57-64`) and
maps onto vector units as pure broadcast arithmetic.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CpmlCoefs(NamedTuple):
    """1-D profiles broadcast against the (nz, nx) grid.

    z-profiles are shaped (nz, 1); x-profiles (1, nx).  *_h are the
    half-grid-point (staggered) variants.
    """

    kz: np.ndarray
    az: np.ndarray
    bz: np.ndarray
    kz_h: np.ndarray
    az_h: np.ndarray
    bz_h: np.ndarray
    kx: np.ndarray
    ax: np.ndarray
    bx: np.ndarray
    kx_h: np.ndarray
    ax_h: np.ndarray
    bx_h: np.ndarray

    def astype(self, dtype):
        return CpmlCoefs(*(p.astype(dtype) for p in self))


def _profiles_1d(n: int, npml: int, dh: float, dt: float, f0: float,
                 cp_ref: float = 3000.0, npower: float = 8.0,
                 rcoef: float = 8e-4, k_max: float = 2.0, half: bool = False):
    thickness = npml * dh
    d0 = -(npower + 1.0) * cp_ref * np.log(rcoef) / (2.0 * thickness)
    alpha_max = 2.0 * np.pi * (f0 / 2.0)

    i = np.arange(n, dtype=np.float64)
    off = 0.5 if half else 0.0
    # distance into the PML from the interior, per edge
    depth_l = (npml - i - off) * dh
    depth_r = (npml - n + i + off) * dh
    depth = np.maximum(depth_l, depth_r)
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


def cpml_profiles(nz: int, nx: int, npml: int, dz: float, dx: float,
                  dt: float, f0: float, dtype=np.float32, **kw) -> CpmlCoefs:
    kz, az, bz = _profiles_1d(nz, npml, dz, dt, f0, **kw)
    kzh, azh, bzh = _profiles_1d(nz, npml, dz, dt, f0, half=True, **kw)
    kx, ax, bx = _profiles_1d(nx, npml, dx, dt, f0, **kw)
    kxh, axh, bxh = _profiles_1d(nx, npml, dx, dt, f0, half=True, **kw)

    col = lambda p: p.reshape(-1, 1).astype(dtype)   # (nz, 1)
    row = lambda p: p.reshape(1, -1).astype(dtype)   # (1, nx)
    return CpmlCoefs(
        kz=col(kz), az=col(az), bz=col(bz),
        kz_h=col(kzh), az_h=col(azh), bz_h=col(bzh),
        kx=row(kx), ax=row(ax), bx=row(bx),
        kx_h=row(kxh), ax_h=row(axh), bx_h=row(bxh),
    )


class CpmlScaled(NamedTuple):
    """Division-free CPML profiles for the hot kernels.

    The per-derivative CPML application

        d   = D / dh                      D = raw stencil difference
        psi <- b psi + a d
        d_e = d / K + psi

    costs two vector divisions per derivative (16 per elastic cell-step;
    an f32 divide is several times a multiply on the VPU).  Folding the
    grid spacing and K into the precomputed profiles,

        a'  = a / dh          ik = 1 / (K dh)
        psi <- b psi + a' D
        d_e = D ik + psi

    is the same recursion exactly (psi takes identical values; d_e is the
    same quantity reassociated), with zero divisions and one fewer
    multiply per derivative.  Profiles are built in float64 and cast, so
    the interior value of ik is exactly dtype(1/dh) — the constant the
    time-reversed reconstruction steps multiply by, keeping forward and
    reconstruction bitwise identical in the interior.
    """

    ikz: np.ndarray
    az: np.ndarray
    bz: np.ndarray
    ikz_h: np.ndarray
    az_h: np.ndarray
    bz_h: np.ndarray
    ikx: np.ndarray
    ax: np.ndarray
    bx: np.ndarray
    ikx_h: np.ndarray
    ax_h: np.ndarray
    bx_h: np.ndarray


def cpml_scaled(nz: int, nx: int, npml: int, dz: float, dx: float,
                dt: float, f0: float, dtype=np.float32, **kw) -> CpmlScaled:
    kz, az, bz = _profiles_1d(nz, npml, dz, dt, f0, **kw)
    kzh, azh, bzh = _profiles_1d(nz, npml, dz, dt, f0, half=True, **kw)
    kx, ax, bx = _profiles_1d(nx, npml, dx, dt, f0, **kw)
    kxh, axh, bxh = _profiles_1d(nx, npml, dx, dt, f0, half=True, **kw)

    col = lambda p: p.reshape(-1, 1).astype(dtype)   # (nz, 1)
    row = lambda p: p.reshape(1, -1).astype(dtype)   # (1, nx)
    return CpmlScaled(
        ikz=col(1.0 / (kz * dz)), az=col(az / dz), bz=col(bz),
        ikz_h=col(1.0 / (kzh * dz)), az_h=col(azh / dz), bz_h=col(bzh),
        ikx=row(1.0 / (kx * dx)), ax=row(ax / dx), bx=row(bx),
        ikx_h=row(1.0 / (kxh * dx)), ax_h=row(axh / dx), bx_h=row(bxh),
    )
