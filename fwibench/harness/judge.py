"""What decides `correct`: the numbers a run compares, each against its
limit (`limits/<cell>.json`), after the window has closed and the port's
state is freed.

invert   x0_gap      max |x0 - x0_ref|: the port's start against the
                     reference's (exact)
         loss_gap    |f - f_ref| / |f_ref| of evaluations drawn from the
                     seed among the window's, at their points
         grad_gap    the worst parameter's max |g - g_ref| over its
                     max |g_ref|, for the same evaluations
forward  data_gap    the worst channel's max |d - d_ref| over its
                     max |d_ref|, for the calls the window kept
both     plain_calls the port's plain versions called in the window (on
                     the card: 0)
         launch_spread  max - min of the launches a unit made (0: every
                     unit launched alike)
         zero_units  units whose loss or gradient (invert), or data ett
                     (forward), is all zero: a zero residual or
                     cotangent proves nothing

The reference (fwibench/reference) rebuilds the true model, the observed
data and the head from the configuration and the seed's arrays; it reads
the port's outputs only to judge them.
"""
from __future__ import annotations

import importlib.util
import json
import math

import numpy as np
import torch

from fwibench.harness.work import HERE
from fwibench.reference import twin


def config_module(name: str):
    """configs/<name>.py, the configuration's plain reference."""
    path = HERE / "configs" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"fwibench_config_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def rel_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / max |ref| (inf when ref is all zero)."""
    den = float(ref.abs().max())
    num = float((a.to(ref.dtype) - ref).abs().max())
    return num / den if den > 0 else math.inf


def grad_gap(g: np.ndarray, g_ref: np.ndarray, n_params: int) -> float:
    return max(rel_gap(torch.from_numpy(a), torch.from_numpy(b))
               for a, b in zip(np.split(g, n_params),
                               np.split(g_ref, n_params)))


def program_numbers(win, on_card: bool, kind: str) -> dict:
    """The numbers taken from the port's run alone."""
    launches = [sum(u.launches.values()) for u in win.units]
    if kind == "invert":
        zero = sum(1 for u in win.units
                   if not (u.f > 0 and np.abs(u.g).max() > 0))
    else:
        zero = sum(1 for d in win.kept.values()
                   if not float(d[:, 3].abs().max()) > 0)
    out = {"launch_spread": max(launches) - min(launches),
           "zero_units": zero}
    if on_card:
        out["plain_calls"] = sum(u.plain for u in win.units)
    return out


def invert_sample(n_units: int, seed: int, k: int) -> list[int]:
    rng = np.random.default_rng([int(seed) % 2 ** 63, 11])
    return sorted(rng.choice(n_units, size=min(k, n_units), replace=False)
                  .tolist())


def reference_invert(cj, fields, noise, answers, x0, *, device,
                     dtype=torch.float32):
    """x0_gap, loss_gap and grad_gap of the port's answers [(x, f, g)]
    against the reference in `dtype`."""
    tw = twin.Twin(cj, config_module(cj["name"]), torch.device(device),
                   dtype)
    tw.set_fields(fields)
    out = {"x0_gap": float(np.abs(x0 - tw.x0()).max())}
    obs = tw.observed(noise)
    lg = gg = 0.0
    for x, f, g in answers:
        f_ref, g_ref = tw.value_and_grad(x, obs)
        lg = max(lg, abs(f - f_ref) / abs(f_ref) if f_ref else math.inf)
        gg = max(gg, grad_gap(g, g_ref, len(cj["params"])))
    out.update(loss_gap=lg, grad_gap=gg)
    return out


def reference_forward(cj, fields, datas, *, device, dtype=torch.float32):
    """data_gap of the port's data against the reference in `dtype`."""
    tw = twin.Twin(cj, config_module(cj["name"]), torch.device(device),
                   dtype)
    tw.set_fields(fields)
    ref = tw.forward(*tw.true_lame())
    gap = 0.0
    for d in datas:
        d = d.to(ref.device)
        gap = max(gap, max(rel_gap(d[:, c], ref[:, c]) for c in range(4)))
    return {"data_gap": gap}


def verdict(numbers: dict, lim: dict):
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number without a limit, or not finite, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = lim.get(name)
        good = (limit is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
