"""Where the trace's stretch lies in a window, on a stub clock of unit
durations and gaps and a stub profiler.  The cells' own units (0.25 s and
2.0 s evaluations, 0.1 s forward calls) keep the stretch from the end of
unit 2 with the count `trace_launches` gives (6, 2 and 13 units), also
after a warm-up that builds and compiles (15.93 s and 8.90 s on one H100):
a second warm unit then gives the steady pace.  Where the window at that
pace could not hold the stretch and one unit more, the trace starts with
the window and still holds two whole units without moving its end, as at
Marmousi scale on one H100 (a 14.6 s warm-up, scipy's 6.5 s before the
first 10.1 s evaluation and 12.6 s after it).  The window's time outside
its units is less only the profiler's starts and stops inside it."""
import types

import pytest
import torch
from torch.autograd import DeviceType

from fwibench.harness import drive, trace
from fwibench.harness import work as wk


START_S, STOP_S = 0.01, 0.05   # the stub profiler's start and stop


class Clock:
    """The host clock of the stub window and of the stretch."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class StubProfile:
    clock = None

    def __init__(self, **kw):
        pass

    def start(self):
        StubProfile.clock.t += START_S

    def stop(self):
        StubProfile.clock.t += STOP_S

    def events(self):
        span = types.SimpleNamespace(start=0.0, end=1000.0)
        return [types.SimpleNamespace(
            device_type=DeviceType.CUDA, time_range=span,
            name="void (anonymous namespace)::fwd_step_kernel<true>(float)")]


@pytest.fixture
def stub_profiler(monkeypatch):
    StubProfile.clock = Clock()
    for module in (trace, drive):
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            perf_counter=StubProfile.clock))
    monkeypatch.setattr(torch.profiler, "profile", StubProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(trace.Stretch, "warm_up", staticmethod(lambda: None))


def window(unit_s, warm_s, per_unit, gaps=(), seconds=30.0):
    """The window's units on a clock that advances gaps[i] (0 past the
    list) before unit i, unit_s for it and for a second warm unit, and the
    profiler's start and stop where they come; and the second warm units
    made."""
    traffic = wk.load("traffic", "forward" if per_unit == 1501 else "invert")
    clock = StubProfile.clock
    made = []

    def again():
        made.append(clock())
        clock.t += unit_s

    stretch = drive._stretch(traffic, per_unit, warm_s, seconds,
                             ["fwd_step_kernel"], torch.device("cuda"), again)
    win = drive.Window([], clock(), 0.0, [19])
    while True:
        clock.t += gaps[len(win.units)] if len(win.units) < len(gaps) else 0
        t0 = clock()
        clock.t += unit_s
        win.units.append(drive.Unit(t0, clock(), 0.0, {}, 0))
        if drive._end_of_unit(win, stretch, seconds):
            break
    win.t1 = win.units[-1].t1
    drive._finish_trace(win, stretch)
    return win, stretch, len(made)


@pytest.mark.parametrize(
        "unit_s,warm_s,per_unit,gaps,n_units,again,first,traced", [
    (0.25, 0.6, 3002, (), 120, 0, 3, 6),       # main001-invert
    (2.0, 2.2, 8002, (0.3, 0.5), 15, 0, 3, 2),  # main004-invert
    (0.1, 0.3, 1501, (), 300, 0, 3, 13),      # main001-forward
    # warm-ups that build and compile: a second warm unit sets the pace
    (0.25, 15.93, 3002, (), 120, 1, 3, 6),    # main001-invert
    (2.0, 8.90, 8002, (0.3, 0.5), 15, 1, 3, 2),  # main004-invert
    (0.1, 5.1, 1501, (), 300, 1, 3, 13),      # main001-forward
    (4.9, 9.0, 8002, (), 7, 1, 3, 2),         # the stretch and one more fit
    # long units: the trace starts with the window
    (10.5, 9.0, 8002, (), 3, 1, 0, 2),
    (10.5, 9.0, 3002, (), 3, 1, 0, 3),        # a longer stretch ends with it
    (14.0, 9.0, 8002, (), 3, 1, 0, 2),        # just under half the window
    (8.0, 9.5, 8002, (), 4, 1, 0, 2),
    (10.1, 14.6, 8004, (6.5, 12.6), 2, 1, 0, 2),  # Marmousi scale, one H100
    (31.0, 9.0, 8002, (), 1, 1, 0, 1),        # one unit fills the window
])
def test_stretch_placement(stub_profiler, unit_s, warm_s, per_unit, gaps,
                           n_units, again, first, traced):
    win, stretch, made = window(unit_s, warm_s, per_unit, gaps)
    # the window still ends at the first unit that crosses --seconds
    assert len(win.units) == n_units
    assert win.units[-1].t1 - win.t0 >= 30.0
    assert n_units == 1 or win.units[-2].t1 - win.t0 < 30.0
    assert made == again
    assert stretch.first == first
    assert win.trace is not None and win.trace_units == traced
    assert win.trace_first == first
    # the window's own time less only the profiler's pauses inside it: a
    # start in set-up and a stop after the window's last unit are not
    inside = START_S * (first > 0) + STOP_S * (first + traced < n_units)
    assert win.paused_s == pytest.approx(inside, abs=1e-9)


def test_nothing_to_trace_in_one_unit(stub_profiler):
    assert drive.TRACE_AFTER == 3
    # a window that one unit fills after a short warm-up: the stretch,
    # from unit 3 on, never starts
    win, stretch, made = window(31.0, 0.5, 8002, seconds=31.0)
    assert len(win.units) == 1 and made == 0 and win.trace is None
    assert stretch.prof is None and stretch.t0 is None
