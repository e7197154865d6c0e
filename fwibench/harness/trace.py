"""A device-only torch.profiler trace of a stretch of whole evaluations or
calls, and what the metrics read from it: busy seconds (the union of the
device intervals), the stretch's length on the host clock, device seconds
by kernel file (`kernels/<kernel>.json`) and by operation, and the idle
gaps labelled by the operations on either side.

The CPU's events are left out: with them, building the event list of one
gradient's trace took over a minute on the host.  The stretch starts at
the end of one evaluation or call and stops at the end of a later one, so
it holds whole periods of the loop, the host's work between them included.
"""
from __future__ import annotations

import re
import time

import torch

from fwibench.harness import work as wk


def short(name: str) -> str:
    """A kernel's or operation's name without return type, namespaces,
    template arguments and parameters."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    s = re.split(r"[(<]", s, maxsplit=1)[0].strip()
    return s.rsplit("::", 1)[-1] or name[:60]


class Stretch:
    """Traces units first..last (0-based) of a loop: `after(i)` is called
    at the end of unit i; the trace runs from the end of unit first-1 to
    the end of unit last."""

    def __init__(self, first: int, last: int, kernels: list[str]):
        self.first, self.last = first, last
        self.kernels = kernels
        self.prof = None
        self.t0 = self.t1 = None
        self.units = 0
        self.spans = []
        self.pauses = []   # host-clock intervals of its starts and stops

    @staticmethod
    def warm_up():
        """Start and stop the profiler once around a small operation: its
        first start initialises the device tracing, which takes seconds."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.events()

    def after(self, i: int):
        if i == self.first - 1:
            from torch.profiler import ProfilerActivity, profile
            t = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CUDA],
                                acc_events=True)
            self.prof.start()
            self.t0 = time.perf_counter()
            self.pauses.append((t, self.t0))
        elif i == self.last and self.prof is not None:
            self.stop(i)

    def stop(self, i: int):
        if self.prof is None or self.t1 is not None:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.units = i - self.first + 1
        from torch.autograd import DeviceType
        self.spans = sorted((e.time_range.start, e.time_range.end, e.name)
                            for e in self.prof.events()
                            if e.device_type == DeviceType.CUDA)
        self.prof = None
        self.pauses.append((self.t1, time.perf_counter()))

    @property
    def done(self) -> bool:
        return self.t1 is not None and self.units > 0 and bool(self.spans)

    def summary(self) -> dict:
        """busy_s, window_s, kernel_s (by kernel file), ops (top 10 by
        device seconds), gaps (top 10 idle gaps by label), events."""
        per_op, kernel_s, gaps = {}, {k: 0.0 for k in self.kernels}, {}
        pats = {k: re.compile(wk.load("kernels", k)["pattern"])
                for k in self.kernels}
        busy, reach, prev = 0.0, self.spans[0][0], "stretch start"
        for t0, t1, name in self.spans:
            sec = (t1 - t0) * 1e-6
            per_op[short(name)] = per_op.get(short(name), 0.0) + sec
            for k, p in pats.items():
                if p.search(name):
                    kernel_s[k] += sec
            if t0 > reach:
                label = f"{prev} -> {short(name)}"
                gaps[label] = gaps.get(label, 0.0) + (t0 - reach) * 1e-6
            busy += max(0.0, t1 - max(t0, reach)) * 1e-6
            if t1 > reach:
                reach, prev = t1, short(name)
        window = self.t1 - self.t0
        span = (reach - self.spans[0][0]) * 1e-6
        gaps["stretch edges on the host clock (before the first and after "
             "the last device op)"] = max(0.0, window - span)
        top = lambda d: sorted(([k, v] for k, v in d.items()),
                               key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": window, "kernel_s": kernel_s,
                "ops": top(per_op), "gaps": top(gaps),
                "events": len(self.spans)}
