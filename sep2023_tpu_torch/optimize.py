"""L-BFGS-B outer loop: PyTorch <-> scipy.optimize bridge with bounds,
result caching and per-iteration checkpointing.

PyTorch counterpart of `sep2023_tpu/optimize.py` (the reference's
PyTorchObjective, `Ops/FWI/obj_wrapper.py`, and its driver loop,
`Main-001-FWI-Anomaly-Vp-Vs-Den.py:127-168`):
  - parameters: a dict of named arrays, flattened to a float64 vector
  - one evaluation (loss and autograd gradient) serves both fun and jac
    (the reference's is_new/cache dedupe, obj_wrapper.py:62-85)
  - bounds packed per parameter (obj_wrapper.py:51-60)
  - a callback that logs the loss history and snapshots parameters each
    iteration (Main-001:137-154 saved .mat files; this saves .npz)
The on-device L-BFGS (`lbfgs_on_device`) is ROADMAP M11.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy import optimize as sciopt
from scipy.io import savemat


class ScipyObjective:
    """Wrap a PyTorch scalar loss over a dict of tensors as a scipy
    objective.  loss_fn(params, *aux) -> scalar tensor; params arrive as
    tensors of `dtype` on `device`, cast from scipy's float64 vector."""

    def __init__(self, loss_fn: Callable[..., torch.Tensor],
                 params0: Dict[str, np.ndarray],
                 bounds: Optional[Dict[str, tuple]] = None,
                 aux: tuple = (), *, device="cpu", dtype=torch.float32):
        self.names = list(params0)
        self.shapes = {n: np.asarray(params0[n]).shape for n in self.names}
        self.sizes = {n: int(np.prod(self.shapes[n])) for n in self.names}
        self.x0 = np.concatenate(
            [np.asarray(params0[n], dtype=np.float64).ravel()
             for n in self.names])
        self._loss = loss_fn
        self._aux = tuple(aux)
        self.device = torch.device(device)
        self.dtype = dtype
        self.bounds = self.pack_bounds(bounds) if bounds else None
        self._cached_x = None
        self.f = None
        self.g = None
        self.n_evals = 0

    # -- packing -------------------------------------------------------------
    def unpack(self, x: np.ndarray) -> Dict[str, torch.Tensor]:
        out, i = {}, 0
        for n in self.names:
            out[n] = torch.as_tensor(
                x[i:i + self.sizes[n]].reshape(self.shapes[n])).to(
                    self.device, self.dtype)
            i += self.sizes[n]
        return out

    def pack_bounds(self, bounds: Dict[str, tuple]) -> sciopt.Bounds:
        lo, hi = [], []
        for n in self.names:
            if n in bounds and bounds[n] is not None:
                l, h = bounds[n]
                lo.append(np.broadcast_to(np.asarray(l, np.float64),
                                          self.shapes[n]).ravel())
                hi.append(np.broadcast_to(np.asarray(h, np.float64),
                                          self.shapes[n]).ravel())
            else:
                lo.append(np.full(self.sizes[n], -np.inf))
                hi.append(np.full(self.sizes[n], np.inf))
        return sciopt.Bounds(np.concatenate(lo), np.concatenate(hi))

    # -- evaluation ----------------------------------------------------------
    def _evaluate(self, x: np.ndarray):
        """(float f, packed float64 gradient) at x."""
        params = {n: p.requires_grad_() for n, p in self.unpack(x).items()}
        f = self._loss(params, *self._aux)
        grads = torch.autograd.grad(f, [params[n] for n in self.names])
        return float(f.detach()), np.concatenate(
            [g.detach().cpu().numpy().astype(np.float64).ravel()
             for g in grads])

    def _ensure(self, x: np.ndarray):
        if self._cached_x is None or not np.array_equal(x, self._cached_x):
            self.f, self.g = self._evaluate(x)
            self._cached_x = np.array(x)
            self.n_evals += 1

    def fun(self, x):
        self._ensure(np.asarray(x))
        return self.f

    def jac(self, x):
        self._ensure(np.asarray(x))
        return self.g


class InversionLogger:
    """Per-iteration checkpointing: loss.txt + parameter/gradient snapshots
    (`Main-001:137-154`); enables manual resume like the reference.
    save_every: snapshot every that many iterations; start_iter: the first
    iteration's number (a later stage continues the count and the files);
    save_mat: also write each snapshot as a .mat file (scipy.io.savemat),
    the reference's format.  loss_history keeps the losses logged."""

    def __init__(self, result_dir: str, objective: ScipyObjective,
                 save_every: int = 1, start_iter: int = 0,
                 save_mat: bool = False):
        self.dir = result_dir
        self.obj = objective
        self.save_every = save_every
        self.it = start_iter
        self.loss_history = []
        self.save_mat = save_mat
        os.makedirs(result_dir, exist_ok=True)

    def _snapshot(self, stem: str, arrays: dict):
        arrays = {n: v.cpu().numpy() for n, v in arrays.items()}
        np.savez(os.path.join(self.dir, f"{stem}.npz"), **arrays)
        if self.save_mat:
            savemat(os.path.join(self.dir, f"{stem}.mat"), arrays)

    def __call__(self, x):
        self.loss_history.append(self.obj.f)
        with open(os.path.join(self.dir, "loss.txt"), "a") as fp:
            fp.write(f"{self.it} {self.obj.f}\n")
        if self.it % self.save_every == 0:
            self._snapshot(f"model_{self.it:04d}",
                           self.obj.unpack(np.asarray(x)))
            self._snapshot(f"grad_{self.it:04d}", self.obj.unpack(self.obj.g))
        self.it += 1


# L-BFGS-B options matching the reference driver (Main-001:157-168).
# The reference also sets disp/iprint; scipy deprecated those (1.18), so
# progress reporting lives in InversionLogger instead.
REFERENCE_LBFGSB_OPTIONS = dict(gtol=1e-16, ftol=1e-12, maxcor=5,
                                maxfun=1500, maxls=6)


def lbfgsb(objective: ScipyObjective, maxiter: int,
           callback: Optional[Callable] = None, **options):
    """scipy's L-BFGS-B from objective.x0 with the reference's options,
    overridden by `options`; disp and iprint are accepted and dropped."""
    opts = dict(REFERENCE_LBFGSB_OPTIONS)
    opts.update(options)
    opts.pop("disp", None)
    opts.pop("iprint", None)
    opts["maxiter"] = maxiter
    return sciopt.minimize(objective.fun, objective.x0, method="L-BFGS-B",
                           jac=objective.jac, bounds=objective.bounds,
                           tol=None, callback=callback, options=opts)
