"""High-level object API mirroring the reference's facade
(`Ops/FWI/propagator.py` ElasticPropagator + `Ops/FWI/survey.py` Model):
construct from physical-grid models and index-based acquisition, call
`apply_forward` or `apply_gradient`.

PyTorch counterpart of `sep2023_tpu/api.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from sep2023_tpu_torch import parallel
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import pad_model


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
    """Forward modeling and adjoint gradients for one (model, survey) pair,
    the gradient on one device or with the shots sharded over several.

    engine='auto' (the default): a float32 survey that fits a plan (a
    receiver row, a multi-row spread, a column, a fiber, a ragged union:
    `parallel.try_plan`) runs through `cuda_engine`, the CUDA kernels on a
    CUDA device and their plain versions on the CPU; float64 runs the plain
    propagator on the device named, and so does a float32 survey no plan
    takes on the CPU.  On another device such a survey raises, naming
    engine='xla': the port runs the plain propagator on the card only when
    asked.  engine='xla' runs the plain propagator on the device named in
    either dtype, the counterpart of the JAX package's XLA engine, which
    its api always runs.  `self.rs` is the planned RowSurvey or
    FiberSurvey, None where the plain propagator runs."""

    def __init__(self, model: Model, survey: Survey, f0: float = 10.0, *,
                 device="cuda", dtype=torch.float32, engine: str = "auto"):
        if engine not in ("auto", "xla"):
            raise ValueError(f"engine must be 'auto' or 'xla', got "
                             f"{engine!r}")
        self.model = model
        self.survey = survey
        self.device = torch.device(device)
        self.dtype = dtype
        self.cfg = SimConfig(nz=model.nz + 2 * model.nPml,
                             nx=model.nx + 2 * model.nPml,
                             dz=model.dz, dx=model.dx, nt=model.nt,
                             dt=model.dt, f0=f0, npml=model.nPml)
        kernel_route = engine == "auto" and dtype == torch.float32
        plan = parallel.try_plan(self.cfg, survey) if kernel_route else None
        if kernel_route and plan is None and self.device.type != "cpu":
            raise ValueError(
                "the survey's receivers lie outside the range the CUDA "
                "kernels record: engine='xla' runs the plain propagator on "
                f"{self.device}")
        self.rs = None if plan is None else plan.rs
        self.geoms = parallel.survey_to_geoms(survey, model.nPml,
                                              device=self.device, dtype=dtype)
        stf = torch.as_tensor(ricker(f0, model.nt, model.dt), dtype=dtype,
                              device=self.device)
        self.stf = stf.expand(survey.n_shots, model.nt).contiguous()

    def _padded(self, vp, vs, rho):
        t = lambda a: torch.as_tensor(a, device=self.device).to(self.dtype)
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
        fwd = parallel.make_forward(self.cfg, self.survey,
                                    use_kernels=self.rs is not None,
                                    device=self.device, dtype=self.dtype)
        return fwd(lam, mu, rr, self.stf).cpu().numpy()

    def apply_gradient(self, model_init: Model, obs: np.ndarray,
                       channels: Sequence[str] = ("ett",),
                       n_devices: int = 0):
        """Misfit + gradients w.r.t. (vp, vs, rho) of `model_init` against
        observed data, plus the per-shot source-wavelet gradient: the
        outputs of the reference's apply_gradient (`propagator.py:141-218`).

        n_devices: shard the shots over a mesh (`parallel.shot_mesh`: 0 =
        every CUDA device on the card, one on the CPU; k CPU shards with
        device='cpu'), the reference's ngpu argument (`propagator.py:141`);
        a shot count the mesh does not divide is padded with zero-weight
        replicas.  The shards run the kernels' loss
        (`make_cuda_sharded_misfit`) where the survey has a plan, else the
        plain propagator's (`make_sharded_misfit`, on the device named).

        Returns dict(misfit, grad_vp, grad_vs, grad_rho, grad_stf); gradients
        are on the PHYSICAL grid (PML collar folded back by the differentiable
        pad, `propagator.py:198`)."""
        S = self.survey.n_shots
        obs = torch.as_tensor(np.asarray(obs)).to(self.device, self.dtype)
        w = torch.ones(S, device=self.device, dtype=self.dtype)
        survey, geoms, ch = self.survey, self.geoms, tuple(channels)
        mesh = parallel.shot_mesh(n_devices, device=self.device, n_shots=S)
        if mesh is not None:
            _, geoms, obs, w, _ = parallel.pad_shots(self.stf, geoms, obs, w,
                                                     len(mesh))
            survey = parallel.pad_survey(survey, len(mesh))
        if self.rs is not None:
            loss = (parallel.make_cuda_misfit(self.cfg, survey, channels=ch)
                    if mesh is None else parallel.make_cuda_sharded_misfit(
                        self.cfg, survey, mesh, channels=ch))
        else:  # engine='xla', float64, or no plan on the CPU
            base = (parallel.make_local_misfit(self.cfg, channels=ch)
                    if mesh is None else parallel.make_sharded_misfit(
                        self.cfg, mesh, channels=ch))
            loss = lambda l, u, r, s, o, w_: base(l, u, r, s, geoms, o, w_)
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device
                                      ).to(self.dtype).requires_grad_()
        vp, vs, rho = t(model_init.vp), t(model_init.vs), t(model_init.rho)
        stf = self.stf.clone().requires_grad_()
        val = loss(*self._padded(vp, vs, rho),
                   parallel._pad_rows(stf, w.shape[0] - S), obs, w)
        grads = torch.autograd.grad(val, (vp, vs, rho, stf))
        out = lambda g: g.detach().cpu().numpy()
        return {
            "misfit": float(val.detach()),
            "grad_vp": out(grads[0]),
            "grad_vs": out(grads[1]),
            "grad_rho": out(grads[2]),
            "grad_stf": out(grads[3]),
        }
