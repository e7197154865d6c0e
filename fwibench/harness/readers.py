"""What the metric files (`metrics/<name>.py`) read from a run: the
window's units and spans, the counters, the trace of a stretch, the set-up
clock and the allocator's peak.  Each returns None where the run has
nothing to read, and the metric is then left out of the result."""
from __future__ import annotations

import dataclasses
import statistics

from fwibench.harness import work as wk
from fwibench.harness.drive import Window, total_launches


@dataclasses.dataclass
class Run:
    config: dict
    traffic: dict
    setup_s: float
    window: Window
    peak_bytes: int


def window_s(run: Run) -> float:
    return run.window.t1 - run.window.t0


def rate_gcell_s(run: Run, kind: str):
    """GCell/s of all units of the window, when the traffic is `kind`."""
    if run.traffic["kind"] != kind or not run.window.units:
        return None
    cells = sum(wk.cells(run.config, s) for s in run.window.chunks)
    return len(run.window.units) * cells / window_s(run) / 1e9


def durations(run: Run):
    return [u.t1 - u.t0 for u in run.window.units]


def outside_units_ms(run: Run):
    """Window time outside the units, per unit, in ms (less the time the
    profiler's start and stop took inside the window)."""
    n = len(run.window.units)
    outside = window_s(run) - sum(durations(run)) - run.window.paused_s
    return outside / n * 1e3 if n else None


def p90_ms(run: Run):
    d = durations(run)
    if len(d) < 2:
        return None
    return {"value": statistics.quantiles(d, n=10)[8] * 1e3,
            "samples": len(d)}


def loss_call_ms(run: Run):
    s = [u.loss_s for u in run.window.units]
    return statistics.fmean(s) * 1e3 if s and max(s) > 0 else None


def launches_per_unit(run: Run):
    n = [total_launches(u.launches) for u in run.window.units]
    return statistics.fmean(n) if n and max(n) > 0 else None


def traced_work(run: Run):
    return wk.units_work(run.traffic, run.window.chunks,
                         run.window.trace_units)


def roofline(run: Run, kernel: str):
    t = run.window.trace
    if t is None:
        return None
    return wk.roofline_pct(kernel, traced_work(run), run.config,
                           t["kernel_s"])


def mfu(run: Run):
    t = run.window.trace
    if t is None:
        return None
    return wk.mfu_pct(traced_work(run), run.config, t["window_s"])


def idle_share(run: Run):
    t = run.window.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
