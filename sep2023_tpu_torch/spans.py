"""Spans and copy counters: where the host time of an evaluation or a
forward call goes, and what it copies between host and device.

    with spans.span("optimize.unpack"):
        ...

records, when the block ends (by an exception too), the span: its name,
id, parent, unit, thread, and t0 and t1 on `time.perf_counter_ns()`, into
`RECORDS`, the newest 65536.  A span's parent is the innermost span open
on its own thread (0 if none).  A span opened with unit=True (an
evaluation) opens a unit unless one is open: until it ends, every span
opened on any thread (a shard's of `parallel._on_mesh`, autograd's device
thread) carries its id as `unit`.  The id is process-wide, since a loop
runs one unit at a time.

`h2d(t)` and `d2h(t)` count one copy between the host and the device, of
the bytes of t, the device-side tensor (what crosses the bus), in the
innermost span open on the calling thread (a span is open on one thread
only, so no lock is needed).

Always on, with no switch: a span costs one to three microseconds of host
time and a copy count about one, and neither touches the device or the
profiler.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

# The newest finished spans, oldest first.
RECORDS: collections.deque = collections.deque(maxlen=65536)

_ids = itertools.count(1)
_local = threading.local()
_unit = 0   # the open unit's id, 0 when none is open


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """A span named `name` (`module.what`); unit=True opens a unit.
    Entered once; recorded in RECORDS when it ends."""

    __slots__ = ("name", "id", "parent", "unit", "thread", "t0", "t1",
                 "h2d", "h2d_bytes", "d2h", "d2h_bytes", "_opens")

    def __init__(self, name: str, unit: bool = False):
        self.name = name
        self._opens = unit

    def __enter__(self):
        global _unit
        try:
            stack = _local.stack
        except AttributeError:
            stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else 0
        if self._opens:
            if _unit:
                self._opens = False
            else:
                _unit = self.id
        self.unit = _unit
        self.thread = threading.get_ident()
        self.h2d = self.h2d_bytes = self.d2h = self.d2h_bytes = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _unit
        self.t1 = time.perf_counter_ns()
        _local.stack.pop()
        if self._opens:
            _unit = 0
        RECORDS.append(self)
        return False


def h2d(t):
    """Count a copy from the host into t, when t lies on a device (a copy
    to a CPU tensor is none); returns t."""
    if not t.is_cpu:
        stack = _stack()
        if stack:
            stack[-1].h2d += 1
            stack[-1].h2d_bytes += t.nbytes
    return t


def d2h(t):
    """Count a copy of t to the host, when t lies on a device; returns t."""
    if not t.is_cpu:
        stack = _stack()
        if stack:
            stack[-1].d2h += 1
            stack[-1].d2h_bytes += t.nbytes
    return t


def select(t0_ns: int, t1_ns: int) -> list:
    """The finished spans that lie inside [t0_ns, t1_ns]."""
    return [s for s in list(RECORDS) if s.t0 >= t0_ns and s.t1 <= t1_ns]


def self_ns(records) -> dict:
    """{id: self time} of each span of records: its duration less the
    union of the intervals its children (among records) cover inside it."""
    kids = collections.defaultdict(list)
    for c in records:
        kids[c.parent].append((c.t0, c.t1))
    out = {}
    for s in records:
        covered, reach = 0, s.t0
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.t1)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = s.t1 - s.t0 - covered
    return out


def per_evaluation(records) -> dict | None:
    """What the evaluations among records spent, each part in ms an
    evaluation: scipy (the self time of `optimize.lbfgsb`, None without
    it), unpack, head, enqueue (the kernel library's calls), wait (the
    self time of `optimize.to_host`), and the KiB copied each way
    (`h2d_kib`, `d2h_kib`); None without an evaluation."""
    evals = {s.id for s in records if s.name == "optimize.evaluate"}
    if not evals:
        return None
    own = self_ns(records)
    inside = [s for s in records if s.unit in evals]
    n = len(evals)

    def ms(names, spans=inside, mine=True):
        return sum(own[s.id] if mine else s.t1 - s.t0
                   for s in spans if s.name in names) / n / 1e6

    scipy = any(s.name == "optimize.lbfgsb" for s in records)
    return {"evaluations": n,
            "scipy": ms({"optimize.lbfgsb"}, records) if scipy else None,
            "unpack": ms({"optimize.unpack"}),
            "head": ms({"heads.apply"}),
            "enqueue": ms({"cuda_engine.forward", "cuda_engine.backward"},
                          mine=False),
            "wait": ms({"optimize.to_host"}),
            "h2d_kib": sum(s.h2d_bytes for s in inside) / n / 1024,
            "d2h_kib": sum(s.d2h_bytes for s in inside) / n / 1024}
