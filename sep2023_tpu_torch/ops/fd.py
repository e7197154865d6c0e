"""O(4) staggered-grid finite-difference operators on (..., nz, nx) fields.

PyTorch counterpart of `sep2023_tpu/ops/fd.py`: the four shifted
first-derivative stencils of the velocity-stress scheme (c1 = 9/8,
c2 = 1/24),

  dminus_*(f)[i] = c1 (f[i]   - f[i-1]) - c2 (f[i+1] - f[i-2])
  dplus_*(f)[i]  = c1 (f[i+1] - f[i]  ) - c2 (f[i+2] - f[i-1])

as zero-padded slice arithmetic over the last two axes, so a leading shot
axis rides along.  The 2-cell halo produces values that callers mask out
(updates are restricted to [2, n-3]).  Division by the grid spacing happens
at the call site.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sep2023_tpu_torch.config import C1, C2


def _padz(f):
    return F.pad(f, (0, 0, 2, 2))


def _padx(f):
    return F.pad(f, (2, 2))


def dz_minus(f):
    p = _padz(f)
    return (C1 * (p[..., 2:-2, :] - p[..., 1:-3, :])
            - C2 * (p[..., 3:-1, :] - p[..., :-4, :]))


def dz_plus(f):
    p = _padz(f)
    return (C1 * (p[..., 3:-1, :] - p[..., 2:-2, :])
            - C2 * (p[..., 4:, :] - p[..., 1:-3, :]))


def dx_minus(f):
    p = _padx(f)
    return (C1 * (p[..., 2:-2] - p[..., 1:-3])
            - C2 * (p[..., 3:-1] - p[..., :-4]))


def dx_plus(f):
    p = _padx(f)
    return (C1 * (p[..., 3:-1] - p[..., 2:-2])
            - C2 * (p[..., 4:] - p[..., 1:-3]))


def update_mask(nz: int, nx: int, lo_z: int, hi_z: int, lo_x: int, hi_x: int,
                *, device, dtype):
    """A separable 0/1 mask (as a (nz,1) x (1,nx) broadcast pair) selecting
    rows [lo_z, hi_z] and cols [lo_x, hi_x] inclusive."""
    iz = torch.arange(nz, device=device)
    ix = torch.arange(nx, device=device)
    mz = ((iz >= lo_z) & (iz <= hi_z)).to(dtype)
    mx = ((ix >= lo_x) & (ix <= hi_x)).to(dtype)
    return mz.reshape(-1, 1), mx.reshape(1, -1)
