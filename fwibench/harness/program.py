"""What the port records of its own host time (`sep2023_tpu_torch.spans`):
its spans and copy counts inside the window's units, selected by each
unit's [t0, t1] on the host clock the benchmark stamps them with
(`time.perf_counter`, the spans' clock), and self times: a span's duration
less the union of the intervals its children cover.  Each returns None
where the port records nothing to read: a span that no unit holds, or a
checkout of the port from before its span module (a traced run lays these
files over such a checkout too).  Any other fault of the import fails the
run."""
from __future__ import annotations

import bisect
import collections
import importlib
import statistics

NS = 1e9
SLACK_NS = 1000   # the benchmark's float seconds against the spans' ns


SPANS = "sep2023_tpu_torch.spans"


def records():
    """The port's finished spans, or None where the port has no span
    module."""
    try:
        spans = importlib.import_module(SPANS)
    except ModuleNotFoundError as e:
        if e.name != SPANS:
            raise
        return None
    return list(spans.RECORDS)


def by_unit(run):
    """[the spans inside unit i] for each unit of the window, or None."""
    recs = records()
    w = run.window
    if not recs or not w.units:
        return None
    lo, hi = w.t0 * NS - SLACK_NS, w.t1 * NS + SLACK_NS
    inside = sorted((s for s in recs if s.t0 >= lo and s.t1 <= hi),
                    key=lambda s: s.t0)
    starts = [s.t0 for s in inside]
    out = []
    for u in w.units:
        a, b = u.t0 * NS - SLACK_NS, u.t1 * NS + SLACK_NS
        out.append([s for s in inside[bisect.bisect_left(starts, a):
                                      bisect.bisect_right(starts, b)]
                    if s.t1 <= b])
    return out


def self_ns(span, recs, lo=None, hi=None) -> float:
    """span's time inside [lo, hi] (its whole interval by default) less
    the union of its children's intervals there."""
    lo = span.t0 if lo is None else max(lo, span.t0)
    hi = span.t1 if hi is None else min(hi, span.t1)
    kids = sorted((max(c.t0, lo), min(c.t1, hi)) for c in recs
                  if c.parent == span.id)
    covered, reach = 0.0, lo
    for a, b in kids:
        a = max(a, reach)
        if b > a:
            covered += b - a
            reach = b
    return max(0.0, hi - lo - covered)


def _named(units, names):
    return [(s, spans) for spans in units for s in spans if s.name in names]


def per_unit_ms(run, names, own=True):
    """The spans named `names` inside the window's units, their self times
    (own) or durations, summed, per unit, in ms; None where no unit holds
    one."""
    units = by_unit(run)
    if units is None:
        return None
    found = _named(units, names)
    if not found:
        return None
    tot = sum(self_ns(s, spans) if own else s.t1 - s.t0 for s, spans in found)
    return tot / len(units) / 1e6


def less_ms(run, name, minus):
    """The durations of the spans named `name` inside the window's units
    less those of the spans named in `minus` (on any thread) that lie
    inside one of them, summed, per unit, in ms; None where no unit holds
    a span named `name`.  (With shot chunks the adjoint runs inside the
    loss, not inside the call into autograd.)"""
    units = by_unit(run)
    if units is None:
        return None
    found = _named(units, {name})
    if not found:
        return None
    outer = [(s.t0, s.t1) for s, _ in found]
    tot = sum(b - a for a, b in outer) \
        - sum(s.t1 - s.t0 for s, _ in _named(units, minus)
              if any(a <= s.t0 and s.t1 <= b for a, b in outer))
    return tot / len(units) / 1e6


def durations_ms(run, name):
    units = by_unit(run)
    if units is None:
        return None
    return [(s.t1 - s.t0) / 1e6 for s, _ in _named(units, {name})]


def p90_ms(run, name):
    d = durations_ms(run, name)
    if not d or len(d) < 2:
        return None
    return {"value": statistics.quantiles(d, n=10)[8], "samples": len(d)}


def mean_ms(run, name):
    d = durations_ms(run, name)
    return statistics.fmean(d) if d else None


def outer_self_ms(run, name):
    """The self time of the spans named `name` inside the window (they
    enclose the units: scipy's loop), less the profiler's start and stop,
    per unit, in ms."""
    recs = records()
    w = run.window
    if not recs or not w.units:
        return None
    lo, hi = w.t0 * NS, w.t1 * NS
    outer = [s for s in recs if s.name == name and s.t0 < hi and s.t1 > lo]
    if not outer:
        return None
    kids = collections.defaultdict(list)
    for s in recs:
        kids[s.parent].append(s)
    tot = sum(self_ns(s, kids[s.id], lo, hi) for s in outer)
    return (tot / NS - w.paused_s) / len(w.units) * 1e3


def copied_kib(run, kind):
    """KiB copied `kind` ('h2d' host to device, 'd2h' back) inside the
    window's evaluations, per evaluation; None without evaluation spans."""
    units = by_unit(run)
    if units is None or not _named(units, {"optimize.evaluate"}):
        return None
    key = kind + "_bytes"
    return sum(getattr(s, key) for spans in units for s in spans) \
        / len(units) / 1024
