"""High-level object API mirroring the reference's facade
(`Ops/FWI/propagator.py` ElasticPropagator + `Ops/FWI/survey.py` Model):
construct from physical-grid models and index-based acquisition, call
`apply_forward`.

PyTorch counterpart of `sep2023_tpu/api.py`.  `apply_gradient` comes with
the gradient (ROADMAP M2/M7).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sep2023_tpu_torch import parallel, propagator
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import pad_model
from sep2023_tpu_torch.ops import cuda_engine


@dataclasses.dataclass
class Model:
    """Physical-grid model container (`survey.py:3-22` of the reference)."""

    nx: int
    nz: int
    dx: float
    dz: float
    nt: int
    dt: float
    nPml: int
    vp: np.ndarray
    vs: np.ndarray
    rho: np.ndarray
    exp_name: str = ""


class ElasticPropagator:
    """Forward modeling for one (model, survey) pair on one device.

    A float32 row survey (one receiver row, contiguous x) runs through
    `cuda_engine.forward_cuda`: the CUDA kernel on a CUDA device, its plain
    version on the CPU.  On the CPU any other survey or dtype runs the plain
    propagator, the counterpart of the JAX package's XLA engine; on any
    other device it raises, since the kernel cannot take it."""

    def __init__(self, model: Model, survey: Survey, f0: float = 10.0, *,
                 device="cuda", dtype=torch.float32):
        self.model = model
        self.survey = survey
        self.device = torch.device(device)
        self.dtype = dtype
        row = (None if survey.ragged
               else cuda_engine.check_row_survey(survey.rec_z + model.nPml,
                                                 survey.rec_x + model.nPml))
        if self.device.type != "cpu":
            if row is None:
                raise NotImplementedError(
                    "the CUDA kernel records one contiguous receiver row; "
                    "ragged or multi-row surveys need FiberSurvey recording "
                    "(ROADMAP K1-fiber).  device='cpu' runs the plain "
                    "propagator.")
            if dtype != torch.float32:
                raise NotImplementedError(
                    f"the CUDA kernel computes in float32, not {dtype}.  "
                    "device='cpu' runs the plain propagator.")
        self.rs = row if dtype == torch.float32 else None
        self.cfg = SimConfig(nz=model.nz + 2 * model.nPml,
                             nx=model.nx + 2 * model.nPml,
                             dz=model.dz, dx=model.dx, nt=model.nt,
                             dt=model.dt, f0=f0, npml=model.nPml)
        self.geoms = parallel.survey_to_geoms(survey, model.nPml,
                                              device=self.device, dtype=dtype)
        stf = torch.as_tensor(ricker(f0, model.nt, model.dt), dtype=dtype,
                              device=self.device)
        self.stf = stf.expand(survey.n_shots, model.nt).contiguous()

    def _padded(self, vp, vs, rho):
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device
                                      ).to(self.dtype)
        vp, vs, rho = t(vp), t(vs), t(rho)
        lam = (vp ** 2 - 2.0 * vs ** 2) * rho
        mu = vs ** 2 * rho
        n = self.model.nPml
        return pad_model(lam, n), pad_model(mu, n), pad_model(rho, n)

    def apply_forward(self, vp=None, vs=None, rho=None) -> np.ndarray:
        """Synthetic seismograms (n_shots, 4, n_rec, nt) for the model (or an
        override), channels (pr, vx, vz, ett)."""
        m = self.model
        lam, mu, rr = self._padded(vp if vp is not None else m.vp,
                                   vs if vs is not None else m.vs,
                                   rho if rho is not None else m.rho)
        if self.rs is not None:
            g = self.geoms
            data = cuda_engine.forward_cuda(self.cfg, self.rs, lam, mu, rr,
                                            self.stf, g.src_z, g.src_x, g.rxz)
        else:  # only on the CPU: __init__ raises elsewhere
            data = propagator.propagate_shots(self.cfg, lam, mu, rr,
                                              self.stf, self.geoms)
        return data.cpu().numpy()
