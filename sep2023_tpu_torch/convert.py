"""Arrays of the JAX package to the port's tensors.

The tests feed one problem to both packages: they build it with
`sep2023_tpu`, take its arrays as numpy (`np.asarray`), and hand them here.
Nothing in this module imports jax; a geometry is read by its field names.
"""
from __future__ import annotations

import numpy as np
import torch

from sep2023_tpu_torch.propagator import ShotGeom


def params_from_numpy(lam, mu, rho, stf, geoms, *, device,
                      dtype=torch.float32):
    """(lam, mu, rho, stf, ShotGeom) as tensors on `device`: material planes
    and wavelets in `dtype`, indices as int64.  `geoms` is any object with
    the ShotGeom field names (the JAX ShotGeom included), shot axis first."""
    t = lambda a: torch.tensor(np.asarray(a), device=device, dtype=dtype)
    i = lambda a: torch.tensor(np.asarray(a), device=device,
                               dtype=torch.int64)
    das_w = getattr(geoms, "das_w", None)
    geom = ShotGeom(src_z=i(geoms.src_z), src_x=i(geoms.src_x),
                    rxz=t(geoms.rxz), rec_z=i(geoms.rec_z),
                    rec_x=i(geoms.rec_x),
                    das_w=None if das_w is None else t(das_w))
    return t(lam), t(mu), t(rho), t(stf), geom
