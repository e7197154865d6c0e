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
and the on-device L-BFGS (`lbfgs_on_device`), the JAX package's optax
L-BFGS with its zoom line search written out in PyTorch, whose parameters
never leave the device.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy import optimize as sciopt
from scipy.io import savemat

from sep2023_tpu_torch import spans


class ScipyObjective:
    """Wrap a PyTorch scalar loss over a dict of tensors as a scipy
    objective.  loss_fn(params, *aux) -> scalar tensor; params arrive as
    tensors of `dtype` on `device` (the card unless the caller asks for
    the CPU), cast from scipy's float64 vector."""

    def __init__(self, loss_fn: Callable[..., torch.Tensor],
                 params0: Dict[str, np.ndarray],
                 bounds: Optional[Dict[str, tuple]] = None,
                 aux: tuple = (), *, device="cuda", dtype=torch.float32):
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
        with spans.span("optimize.unpack"):
            for n in self.names:
                out[n] = spans.h2d(torch.as_tensor(
                    x[i:i + self.sizes[n]].reshape(self.shapes[n])).to(
                        self.device, self.dtype))
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
        with spans.span("optimize.evaluate", unit=True):
            params = {n: p.requires_grad_()
                      for n, p in self.unpack(x).items()}
            with spans.span("optimize.loss"):
                f = self._loss(params, *self._aux)
            with spans.span("optimize.grad"):
                grads = torch.autograd.grad(f, [params[n]
                                                for n in self.names])
            with spans.span("optimize.to_host"):
                value = float(spans.d2h(f.detach()))
                grads = [spans.d2h(g.detach()).cpu() for g in grads]
            del params, f   # the graph is freed inside the evaluation
            return value, np.concatenate(
                [g.numpy().astype(np.float64).ravel() for g in grads])

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


class LbfgsHistory(list):
    """The objective at the start of every iteration of `lbfgs_on_device`
    (floats), and `n_evals`, the evaluations of value and gradient it took:
    the first one and every trial of the line searches."""

    n_evals = 0


def _vdot(x: dict, y: dict) -> float:
    """sum over the parameters (sorted by name, optax's tree order) of
    <x[k], y[k]>."""
    return float(sum((x[k] * y[k]).sum() for k in sorted(x)))


def _axpy(x: dict, a: float, y: dict) -> dict:
    """x + a y, parameter by parameter (optax.tree.add_scale)."""
    a = float(a)
    return {k: x[k] + a * y[k] for k in x}


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa) with slope fpa at a,
    (b, fb) and (c, fc); NaN where there is none (optax's _cubicmin)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0, r1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r0 - db ** 2 * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * C)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the parabola through (a, fa) with slope fpa at
    a and through (b, fb) (optax's _quadmin)."""
    db = b - a
    B = (fb - fa - fpa * db) / db ** 2
    return a - fpa / (2.0 * B)


class _Zoom:
    """optax's zoom line search (`scale_by_zoom_linesearch` of optax 0.2.6
    with max_linesearch_steps=20 and initial_guess_strategy='one', the
    line search of `optax.lbfgs`): an interval search doubling the step
    from 1, then a zoom by cubic, quadratic or bisection steps, until both
    the decrease (Armijo, or the approximate decrease of Hager and Zhang)
    and the curvature criteria hold, or a safe step that decreases enough
    is taken after 20 trials.  Scalars are float64 on the host; every trial
    is one value_and_grad on the device."""

    MAX_STEPS = 20
    INCREASE = 2.0
    SLOPE_RTOL = 1e-4
    CURV_RTOL = 0.9
    APPROX_DEC_RTOL = 1e-6
    INTERVAL_THRESHOLD = 1e-5

    def __init__(self, value_and_grad, params, updates, value, grad):
        self.vg, self.params, self.updates = value_and_grad, params, updates
        slope = np.float64(_vdot(updates, grad))
        value = np.float64(value)
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = (
            np.float64(0.0), value, grad, slope)
        self.value_init, self.slope_init = value, slope
        self.decrease_error = np.float64(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = np.float64(0.0), value, \
            slope
        self.high, self.value_high, self.slope_high = np.float64(0.0), \
            value, slope
        self.cubic_ref, self.value_cubic_ref = np.float64(0.0), value
        self.safe_stepsize, self.safe_value, self.safe_grad = (
            np.float64(0.0), value, grad)

    def _on_line(self, stepsize):
        value, grad = self.vg(_axpy(self.params, float(stepsize),
                                    self.updates))
        return np.float64(value), grad, np.float64(_vdot(grad, self.updates))

    def _errors(self, stepsize, value, slope):
        dec = value - self.value_init - self.SLOPE_RTOL * stepsize * \
            self.slope_init
        approx = np.maximum(
            slope - (2 * self.SLOPE_RTOL - 1.0) * self.slope_init,
            value - self.value_init
            - self.APPROX_DEC_RTOL * np.abs(self.value_init))
        dec = np.maximum(np.minimum(approx, dec), 0.0)
        dec = np.inf if np.isnan(dec) else dec
        curv = np.maximum(np.abs(slope) - self.CURV_RTOL
                          * np.abs(self.slope_init), 0.0)
        curv = np.inf if np.isnan(curv) else curv
        return dec, max(dec, curv)

    def _search_interval(self):
        prev = (self.stepsize, self.value, self.slope)
        new = (np.float64(1.0) if self.count == 0
               else self.INCREASE * self.stepsize)
        value, grad, slope = self._on_line(new)
        dec, error = self._errors(new, value, slope)
        if dec <= 0.0:
            self.safe_stepsize, self.safe_value, self.safe_grad = (new, value,
                                                                   grad)
        high_to_new = dec > 0.0 or (value >= prev[1] and self.count > 0)
        low_to_new = slope >= 0.0 and not high_to_new
        if low_to_new:
            (self.low, self.value_low, self.slope_low), \
                (self.high, self.value_high, self.slope_high) = \
                (new, value, slope), prev
        else:
            (self.low, self.value_low, self.slope_low), \
                (self.high, self.value_high, self.slope_high) = \
                prev, (new, value, slope)
        self.interval_found = high_to_new or low_to_new or error <= 0.0
        self.done = error <= 0.0
        self.failed = self.count + 1 >= self.MAX_STEPS and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self._take(new, value, grad, slope, dec)

    def _zoom_into_interval(self):
        low, value_low, slope_low = self.low, self.value_low, self.slope_low
        high, value_high, slope_high = (self.high, self.value_high,
                                        self.slope_high)
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                          self.cubic_ref, self.value_cubic_ref)
        quad = _quadmin(low, value_low, slope_low, high, value_high)
        if left + 0.2 * delta < cubic < right - 0.2 * delta:
            middle = cubic
        elif left + 0.1 * delta < quad < right - 0.1 * delta:
            middle = quad
        else:
            middle = (low + high) / 2.0
        value, grad, slope = self._on_line(middle)
        dec, error = self._errors(middle, value, slope)
        if dec <= 0.0 and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                middle, value, grad)
        self.done = error <= 0.0
        high_to_middle = dec > 0.0 or value >= value_low
        high_to_low = slope * (high - low) >= 0.0 and not high_to_middle
        if high_to_middle:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if high_to_low:
            self.high, self.value_high, self.slope_high = (low, value_low,
                                                           slope_low)
        if not high_to_middle:
            self.low, self.value_low, self.slope_low = middle, value, slope
        self.cubic_ref, self.value_cubic_ref = (
            (high, value_high) if high_to_middle or high_to_low
            else (low, value_low))
        self.failed = (self.count + 1 >= self.MAX_STEPS
                       or (delta <= self.INTERVAL_THRESHOLD
                           and self.safe_stepsize > 0.0)) and not self.done
        self._take(middle, value, grad, slope, dec)

    def _take(self, stepsize, value, grad, slope, dec):
        self.stepsize, self.value, self.grad, self.slope = (stepsize, value,
                                                            grad, slope)
        self.decrease_error = dec
        self.count += 1

    def run(self):
        """(stepsize, value, gradient) of the accepted step."""
        with np.errstate(all="ignore"):  # NaN and inf are part of the rules
            return self._run()

    def _run(self):
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom_into_interval()
            else:
                self._search_interval()
            if self.failed and (self.safe_stepsize > 0.0
                                or np.isinf(self.decrease_error)):
                # the step with a sufficient decrease, or none at all
                self.stepsize, self.value, self.grad = (
                    self.safe_stepsize, self.safe_value, self.safe_grad)
        return self.stepsize, self.value, self.grad


def lbfgs_on_device(loss_fn, params0: Dict[str, np.ndarray], n_iter: int,
                    bounds: Optional[Dict[str, tuple]] = None,
                    memory_size: int = 5, aux: tuple = (), *, device="cuda",
                    dtype=torch.float32):
    """On-device L-BFGS with box projection, the scipy bridge's alternative
    whose parameters never leave the device (`sep2023_tpu/optimize.py`'s
    lbfgs_on_device).  loss_fn(params, *aux) -> scalar tensor, params a dict
    of tensors of `dtype` on `device`.

    The algorithm of `optax.lbfgs(memory_size=memory_size)` (optax 0.2.6):
    the two-loop recursion over the last memory_size differences, its
    identity scaled by <dg, dp> / <dg, dg> and the first step by
    min(1, 1 / |g|), along -H g with the zoom line search (`_Zoom`), whose
    last value and gradient start the next iteration, so an iteration costs
    only its line search's trials.  With bounds it minimises
    loss(clip(p)) + |p - clip(p)|^2 / 2 (projected L-BFGS: the pullback
    keeps the curvature pairs consistent) and returns clip(p).

    Returns (clip(params), history): the objective at the start of each
    iteration, an LbfgsHistory with n_evals."""
    device = torch.device(device)
    names = list(params0)
    tensor = lambda a: torch.as_tensor(np.asarray(a)).to(device, dtype)
    params = {k: tensor(params0[k]) for k in names}

    if bounds:
        inf = np.inf
        lo = {k: tensor(bounds[k][0] if bounds.get(k) is not None else -inf)
              for k in names}
        hi = {k: tensor(bounds[k][1] if bounds.get(k) is not None else inf)
              for k in names}
        # jnp.clip: maximum then minimum, a tie sends half the gradient on
        # in both packages
        clip = lambda p: {k: torch.minimum(torch.maximum(p[k], lo[k]), hi[k])
                          for k in p}

        def obj(p, *a):
            pc = clip(p)
            pen = sum(((p[k] - pc[k]) ** 2).sum() for k in p)
            return loss_fn(pc, *a) + 0.5 * pen
    else:
        clip = lambda p: p
        obj = loss_fn

    history = LbfgsHistory()

    def value_and_grad(p):
        history.n_evals += 1
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        with spans.span("optimize.evaluate", unit=True):
            with torch.enable_grad():
                with spans.span("optimize.loss"):
                    val = obj(leaves, *aux)
                with spans.span("optimize.grad"):
                    grads = torch.autograd.grad(val, [leaves[k]
                                                      for k in names])
            with spans.span("optimize.to_host"):
                value = float(spans.d2h(val.detach()))
            del leaves, val   # the graph is freed inside the evaluation
        return value, dict(zip(names, grads))

    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
    mem_dp = [zeros() for _ in range(memory_size)]
    mem_dg = [zeros() for _ in range(memory_size)]
    rho = np.zeros(memory_size)
    prev_params, prev_grad = zeros(), zeros()
    value = np.inf
    for count in range(n_iter):
        if not np.isfinite(value):
            value, grad = value_and_grad(params)
        history.append(float(value))
        # scale_by_lbfgs: the memory at the new point, then H g
        idx, prev_idx = count % memory_size, (count - 1) % memory_size
        if count > 0:
            dp = _axpy(params, -1.0, prev_params)
            dg = _axpy(grad, -1.0, prev_grad)
            curv, denom = _vdot(dg, dp), _vdot(dg, dg)
            weight = 0.0 if curv == 0.0 else 1.0 / curv
            scale = curv / denom if denom > 0.0 else 1.0
        else:
            dp, dg, weight = zeros(), zeros(), 0.0
            with np.errstate(divide="ignore"):
                scale = min(1.0, 1.0 / np.sqrt(_vdot(grad, grad)))
        mem_dp[prev_idx], mem_dg[prev_idx], rho[prev_idx] = dp, dg, weight
        order = [(idx + j) % memory_size for j in range(memory_size)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = rho[i] * _vdot(mem_dp[i], vec)
            vec = _axpy(vec, -alphas[i], mem_dg[i])
        vec = {k: scale * v for k, v in vec.items()}
        for i in order:
            beta = rho[i] * _vdot(mem_dg[i], vec)
            vec = _axpy(vec, alphas[i] - beta, mem_dp[i])
        prev_params, prev_grad = params, grad
        updates = {k: -v for k, v in vec.items()}
        stepsize, value, grad = _Zoom(value_and_grad, params, updates, value,
                                      grad).run()
        params = _axpy(params, stepsize, updates)
    return clip(params), history


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
    with spans.span("optimize.lbfgsb"):
        return sciopt.minimize(objective.fun, objective.x0,
                               method="L-BFGS-B", jac=objective.jac,
                               bounds=objective.bounds, tol=None,
                               callback=callback, options=opts)
