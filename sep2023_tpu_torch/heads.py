"""Model parameterization heads: differentiable maps from inversion
parameters (on the physical grid) to padded (lam, mu, rho) in SI units.

PyTorch counterpart of `sep2023_tpu/heads.py` (the reference's nn.Module
heads, `FWI_ops.py:66-619`).  Each head is a function

    params (dict of (nz_phys, nx_phys) tensors)  ->  (lam, mu, rho) padded

composed of a bilinear resize + replicate pad onto the padded grid, a mask
blend against frozen padded reference fields
(`X = mask * X_pad + (1-mask) * X_ref`, FWI_ops.py:120-122) and the head's
physics map.  Autograd supplies every head's chain rule.  The two rock
physics heads need `rock_physics`, not ported yet (ROADMAP M4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sep2023_tpu_torch.config import Grid
from sep2023_tpu_torch.medium import resize_and_pad


@dataclasses.dataclass
class Head:
    """A parameterization head.

    grid        : padded Grid
    param_names : inversion parameter names, in flattening order
    refs        : frozen PADDED reference fields, one per param (mask blend)
    mask        : (nz, nx) blend mask (1 = invert here); default all ones
    to_lame     : padded blended params -> (lam, mu, rho)
    bounds      : optional {name: (lo, hi)} scalar or per-pixel L-BFGS-B bounds
    """

    grid: Grid
    param_names: Tuple[str, ...]
    refs: Dict[str, torch.Tensor]
    mask: torch.Tensor
    to_lame: Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    bounds: Optional[Dict[str, Tuple]] = None

    def blend(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for name in self.param_names:
            p = params[name]
            pad = resize_and_pad(p, self.grid.nz_phys, self.grid.nx_phys,
                                 self.grid.npml)
            mask = self.mask.to(p.device, p.dtype)
            ref = self.refs[name].to(p.device, p.dtype)
            out[name] = mask * pad + (1.0 - mask) * ref
        return out

    def apply(self, params: Dict[str, torch.Tensor]):
        b = self.blend(params)
        return self.to_lame(*(b[n] for n in self.param_names))


def _make(grid: Grid, names, init: Dict[str, np.ndarray], to_lame,
          mask=None, bounds=None) -> Head:
    """Reference fields and mask are kept in float64 on the CPU and cast to
    the parameters' dtype and device when blended."""
    f64 = torch.float64
    mask = (torch.ones(grid.shape, dtype=f64) if mask is None
            else torch.as_tensor(np.asarray(mask), dtype=f64))
    refs = {n: resize_and_pad(torch.as_tensor(np.asarray(init[n]), dtype=f64),
                              grid.nz_phys, grid.nx_phys, grid.npml)
            for n in names}
    return Head(grid=grid, param_names=tuple(names), refs=refs, mask=mask,
                to_lame=to_lame, bounds=bounds)


# -- the heads ---------------------------------------------------------------

def vp_vs_rho(grid, init, mask=None, bounds=None) -> Head:
    """(Vp, Vs, rho) head (`FWI` module, FWI_ops.py:66-127)."""
    def to_lame(vp, vs, rho):
        return (vp ** 2 - 2.0 * vs ** 2) * rho, vs ** 2 * rho, rho
    return _make(grid, ("vp", "vs", "rho"), init, to_lame, mask, bounds)


def lame_rho(grid, init, mask=None, bounds=None) -> Head:
    """(lambda, mu, rho) head (`FWI_Lame_Den`, FWI_ops.py:146-204)."""
    def to_lame(lam, mu, rho):
        return lam, mu, rho
    return _make(grid, ("lam", "mu", "rho"), init, to_lame, mask, bounds)


def ip_is_rho(grid, init, mask=None, bounds=None) -> Head:
    """(P-impedance, S-impedance, rho) head (`FWI_IP_IS_Den`,
    FWI_ops.py:208-267): lam = (IP^2 - 2 IS^2)/rho, mu = IS^2/rho."""
    def to_lame(ip, is_, rho):
        return (ip ** 2 - 2.0 * is_ ** 2) / rho, is_ ** 2 / rho, rho
    return _make(grid, ("ip", "is", "rho"), init, to_lame, mask, bounds)


def vp_vs_ip(grid, init, mask=None, bounds=None) -> Head:
    """(Vp, Vs, IP) head (`FWI_Vp_Vs_IP`, FWI_ops.py:270-330): rho = IP/Vp."""
    def to_lame(vp, vs, ip):
        rho = ip / vp
        return ip * vp - 2.0 * rho * vs ** 2, rho * vs ** 2, rho
    return _make(grid, ("vp", "vs", "ip"), init, to_lame, mask, bounds)


def vp_vs_is(grid, init, mask=None, bounds=None) -> Head:
    """(Vp, Vs, IS) head (`FWI_Vp_Vs_IS`, FWI_ops.py:333-395): rho = IS/Vs."""
    def to_lame(vp, vs, is_):
        rho = is_ / vs
        return rho * vp ** 2 - 2.0 * is_ * vs, is_ * vs, rho
    return _make(grid, ("vp", "vs", "is"), init, to_lame, mask, bounds)


def _rock_head(name):
    def head(grid, init, mask=None, bounds=None) -> Head:
        raise NotImplementedError(
            f"the {name} head needs rock_physics, not ported yet "
            "(ROADMAP M4)")
    head.__name__ = name
    return head


rock_vrh = _rock_head("rock_vrh")
rock_gassmann = _rock_head("rock_gassmann")

HEADS = {
    "vp_vs_rho": vp_vs_rho,
    "lame_rho": lame_rho,
    "ip_is_rho": ip_is_rho,
    "vp_vs_ip": vp_vs_ip,
    "vp_vs_is": vp_vs_is,
    "rock_vrh": rock_vrh,
    "rock_gassmann": rock_gassmann,
}


def default_mask(grid: Grid, freeze_top_rows: int = 4) -> np.ndarray:
    """The reference's standard mask: invert the physical region, freeze the
    PML collar and the first rows below the surface (Main-001:40-42)."""
    m = np.zeros(grid.shape, dtype=np.float64)
    zi, xi = grid.interior_slices()
    m[zi, xi] = 1.0
    m[grid.npml:grid.npml + freeze_top_rows, :] = 0.0
    return m
