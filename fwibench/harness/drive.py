"""The general generator: builds a configuration's problem through the
port, as `python -m sep2023_tpu_torch invert` and `forward` build theirs,
and drives one traffic mix (`traffic/<name>.json`, by its `kind`) over a
window of whole evaluations or calls, with the benchmark's own spans and
counter deltas around each.

invert   scipy L-BFGS-B (`optimize.lbfgsb`) over `optimize.ScipyObjective`
         on the loss `cli.build_stage_loss` builds, from the published
         start; restarted from its last iterate if scipy stops.  A closed
         loop: each evaluation waits for the last.
forward  calls of the forward `parallel.make_forward` returns on the true
         model, one at a time, each call's data copied to the host.

The window starts at the first timed unit and ends at the end of the first
unit that finishes after `seconds`.  Only the port's public functions are
called; its state is never read but through its launch counters.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fwibench import inputs
from fwibench.harness.trace import Stretch

# The port's launch counters, by module.
COUNTERS = (("cuda_engine", ("LAUNCHES", "LAUNCHES_STRIPS", "LAUNCHES_FIBER",
                             "LAUNCHES_BWD", "LAUNCHES_ILL")),
            ("cuda_acoustic", ("LAUNCHES_AC", "LAUNCHES_AC_STRIPS",
                               "LAUNCHES_AC_BWD", "LAUNCHES_AC_IMG")))
# Those that count every launch once (the others count subsets of them).
TOTALS = ("LAUNCHES", "LAUNCHES_BWD", "LAUNCHES_ILL", "LAUNCHES_AC",
          "LAUNCHES_AC_BWD")


class WindowClosed(Exception):
    """Raised from inside scipy's loop when the window has closed."""


@dataclasses.dataclass
class Unit:
    """One evaluation or call: host-clock start and end, the part spent
    in the call into the loss, counter deltas, and the answer (invert: x,
    f, g; forward: nothing, see Window.kept)."""

    t0: float
    t1: float
    loss_s: float
    launches: dict
    plain: int
    x: np.ndarray | None = None
    f: float | None = None
    g: np.ndarray | None = None


@dataclasses.dataclass
class Window:
    units: list
    t0: float
    t1: float
    chunks: list            # shots of each chunk of one unit
    x0: np.ndarray | None = None
    kept: dict = dataclasses.field(default_factory=dict)  # call -> data
    restarts: int = 0
    trace: dict | None = None
    trace_units: int = 0
    trace_first: int | None = None   # the first traced unit
    marks: dict = dataclasses.field(default_factory=dict)  # set-up clock
    paused_s: float = 0.0   # window time the profiler's start and stop took


def _port():
    from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine
    return {"cuda_engine": cuda_engine, "cuda_acoustic": cuda_acoustic}


def counts():
    """({counter: value}, total plain calls)."""
    mods = _port()
    c = {n: getattr(mods[m], n) for m, names in COUNTERS for n in names
         if hasattr(mods[m], n)}
    return c, sum(mods["cuda_engine"].PLAIN_CALLS.values())


def delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c1}


def total_launches(launches: dict) -> int:
    return sum(launches.get(k, 0) for k in TOTALS)


@dataclasses.dataclass
class Problem:
    """A configuration built through the port, on one device."""

    cfg: object             # SimConfig
    survey: object          # Survey
    geoms: object
    stf: torch.Tensor
    head: object
    start: dict             # published start, float64 numpy
    bounds: dict | None
    init_t: dict
    true_lame: tuple
    shot_chunk: int
    chunks: list


def build(cj: dict, traffic: dict, fields: np.ndarray, device) -> Problem:
    """The problem of configuration `cj` as `cli.cmd_invert` builds it with
    a survey of its own (`--survey-json`): the grid and wavelet of
    `cli.benchmark_problem`, the configuration's line survey (its layout
    keys src_z, src_x0, src_dx, n_shots, rec_z, rec_x0, n_rec) as a
    `config.Survey` and `parallel.survey_to_geoms`, the wavelet a row a
    shot, tapered; the twin experiment's true and start models of the
    configuration's head (the true one perturbed by the seed's fields),
    the stability and reach checks, the shot chunk of
    `parallel.auto_shot_chunk`."""
    from sep2023_tpu_torch import cli, config, heads, medium, models
    from sep2023_tpu_torch import parallel, survey_tools
    from sep2023_tpu_torch.ops import signal as sg

    from fwibench.reference import twin

    dtype = torch.float32
    cfg, _, _, stf = cli.benchmark_problem(
        nz=cj["nz"], nx=cj["nx"], dz=cj["dz"], dx=cj["dx"], nt=cj["nt"],
        dt=cj["dt"], f0=cj["f0"], npml=cj["npml"], wavelet=cj["wavelet"],
        device=device, dtype=dtype)
    survey = config.Survey(*twin.survey(cj))
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device=device,
                                     dtype=dtype)
    laid = twin.geom(cj, device=device, dtype=dtype)
    if not all(torch.equal(getattr(geoms, k), getattr(laid, k))
               for k in ("src_z", "src_x", "rec_z", "rec_x")):
        raise ValueError(f"{cj['name']}: the port places a source or a "
                         "receiver elsewhere than the configuration")
    stf = stf[0].expand(survey.n_shots, cfg.nt)
    stf = (stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=device,
                                 dtype=dtype)).contiguous()
    true, init, bounds, names = models.twin_experiment_setup(
        cj["head"], cj["nz"], cj["nx"], model=cj["model"], dtype=dtype)
    if tuple(names) != tuple(cj["params"]):
        raise ValueError(f"head {cj['head']} inverts {names}, the "
                         f"configuration names {cj['params']}")
    true = inputs.perturbed(true, fields, cj)
    head = heads.HEADS[cj["head"]](
        cfg.grid, init, mask=heads.default_mask(cfg.grid,
                                                cj["freeze_top_rows"]),
        bounds=bounds)

    def tensors(params):
        return {k: torch.as_tensor(np.asarray(v)).to(device, dtype)
                for k, v in params.items()}

    lam_t, mu_t, rho_t = head.apply(tensors(true))
    vp_max = float(torch.sqrt((lam_t + 2 * mu_t) / rho_t).max())
    cfg.check_stability(vp_max)
    if survey_tools.check_reach(cfg, survey, vp_max, warn=False):
        raise ValueError(f"{cj['name']}: a shot reaches no receiver")
    if medium.check_lambda(lam_t) < 0:
        raise ValueError(f"{cj['name']}: the seed's true model has lam < 0")
    S = survey.n_shots
    if traffic["shot_chunk"] == "auto":
        chunk = parallel.auto_shot_chunk(cfg, S, device=device)
    else:
        chunk = int(traffic["shot_chunk"])
    sizes = [b - a for a, b in parallel._chunks(S, chunk)]
    start = {k: np.asarray(init[k]) for k in names}
    return Problem(cfg, survey, geoms, stf, head, start,
                   {k: bounds[k] for k in names} if bounds else None,
                   tensors(init), (lam_t, mu_t, rho_t), chunk, sizes)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# The first units a trace leaves out: scipy's first iterations set up its
# state between them (150-230 ms after the first evaluation at main001).
TRACE_AFTER = 3


def _stretch(traffic, launches_per_unit, warm_s, seconds, kernels, device,
             again):
    """With kernels to trace, on the card: the units a trace covers, as
    many as hold about traffic['trace_launches'] kernel launches, at least
    two, from unit TRACE_AFTER on; or, where the window at the steady pace
    could not hold those units and one more, from the window's start (the
    profiler started here).  The steady pace is the time of a second warm
    unit, `again()`, made only where the first one (`warm_s`, which may
    build and compile) was that long: at Marmousi scale, 10 s evaluations
    with scipy's steps between them, a later start traced one unit.  The
    profiler is started and stopped once here, in set-up, so that its
    first start's cost stays out of the window."""
    if not kernels or device.type != "cuda":
        return None
    n = max(2, traffic["trace_launches"] // max(1, launches_per_unit))
    Stretch.warm_up()
    first = TRACE_AFTER
    if (TRACE_AFTER + n + 1) * warm_s > seconds:
        t0 = time.perf_counter()
        again()
        if (TRACE_AFTER + n + 1) * (time.perf_counter() - t0) > seconds:
            first = 0
    stretch = Stretch(first, first + n - 1, kernels)
    if first == 0:
        stretch.after(-1)
    return stretch


def _end_of_unit(win: Window, stretch, seconds) -> bool:
    """Passes the window's last unit to the stretch; True when the window
    has closed."""
    if stretch is not None:
        stretch.after(len(win.units) - 1)
    return win.units[-1].t1 - win.t0 >= seconds


def run_invert(p: Problem, cj, traffic, noise, seconds, *, device,
               trace_kernels=None):
    """Set-up (observed data, one warm evaluation) and the window.  Returns
    (window, set-up end on the host clock)."""
    from sep2023_tpu_torch import cli, optimize, parallel

    dtype = torch.float32
    fwd = parallel.make_forward(p.cfg, p.survey, use_kernels=True,
                                shot_chunk=p.shot_chunk, device=device,
                                dtype=dtype)
    obs = inputs.add_noise(fwd(*p.true_lame, p.stf).to(dtype), noise, cj)
    _sync(device)
    marks = {"data": time.perf_counter()}
    if traffic["objective"] != "l2" or list(traffic["channels"]) != ["ett"]:
        raise ValueError("the reference judges L2 on ett only")
    data_loss = cli.build_stage_loss(
        p.cfg, p.survey, p.geoms, use_kernels=True, shot_chunk=p.shot_chunk,
        channels=traffic["channels"], objective=traffic["objective"])
    weights = cli.shot_weights(p.survey, device=device, dtype=dtype)
    loss_s = [0.0]

    def param_loss(params, stf_, obs_):
        t0 = time.perf_counter()
        lam, mu, rho = p.head.apply({**p.init_t, **params})
        out = data_loss(lam, mu, rho, stf_, obs_, weights)
        loss_s[0] += time.perf_counter() - t0
        return out

    def objective(start):
        return optimize.ScipyObjective(param_loss, start, bounds=p.bounds,
                                       aux=(p.stf, obs), device=device,
                                       dtype=dtype)

    # warm-up: one evaluation, as the window makes them
    warm = objective(p.start)
    c0, _ = counts()
    t0 = time.perf_counter()
    warm._evaluate(warm.x0)
    _sync(device)
    per_unit = total_launches(delta(c0, counts()[0]))
    marks["warm-up"] = time.perf_counter()

    def again():
        warm._evaluate(warm.x0)
        _sync(device)
        marks["steady unit"] = time.perf_counter()

    stretch = _stretch(traffic, per_unit, marks["warm-up"] - t0, seconds,
                       trace_kernels, device, again)
    marks["profiler"] = t_setup = time.perf_counter()

    units = []
    win = Window(units, time.perf_counter(), 0.0, p.chunks,
                 x0=np.array(warm.x0), marks=marks)
    start = p.start
    while True:
        obj = objective(start)
        evaluate = obj._evaluate

        def timed(x, evaluate=evaluate):
            loss_s[0] = 0.0
            (c0, pl0), t0 = counts(), time.perf_counter()
            f, g = evaluate(x)
            t1 = time.perf_counter()
            c1, pl1 = counts()
            units.append(Unit(t0, t1, loss_s[0], delta(c0, c1), pl1 - pl0,
                              np.array(x), f, g))
            if _end_of_unit(win, stretch, seconds):
                raise WindowClosed
            return f, g

        obj._evaluate = timed
        try:
            res = optimize.lbfgsb(obj, maxiter=traffic["maxiter"])
        except WindowClosed:
            break
        start = {k: v.cpu().numpy() for k, v in obj.unpack(res.x).items()}
        win.restarts += 1
    win.t1 = units[-1].t1
    _finish_trace(win, stretch)
    return win, t_setup


def run_forward(p: Problem, traffic, seed, seconds, *, device,
                trace_kernels=None):
    """Set-up (one warm call) and the window; keeps traffic['checked_calls']
    calls' host data, drawn uniformly from the seed (reservoir sampling)."""
    from sep2023_tpu_torch import parallel

    fwd = parallel.make_forward(p.cfg, p.survey, use_kernels=True,
                                shot_chunk=p.shot_chunk, device=device,
                                dtype=torch.float32)
    c0, _ = counts()
    t0 = time.perf_counter()
    fwd(*p.true_lame, p.stf).cpu()
    per_unit = total_launches(delta(c0, counts()[0]))
    marks = {"warm-up": time.perf_counter()}

    def again():
        fwd(*p.true_lame, p.stf).cpu()
        marks["steady unit"] = time.perf_counter()

    stretch = _stretch(traffic, per_unit, marks["warm-up"] - t0, seconds,
                       trace_kernels, device, again)
    marks["profiler"] = t_setup = time.perf_counter()

    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    k = traffic["checked_calls"]
    units = []
    win = Window(units, time.perf_counter(), 0.0, p.chunks, marks=marks)
    while True:
        (c0, pl0), t0 = counts(), time.perf_counter()
        host = fwd(*p.true_lame, p.stf).cpu()
        t1 = time.perf_counter()
        c1, pl1 = counts()
        i = len(units)
        units.append(Unit(t0, t1, 0.0, delta(c0, c1), pl1 - pl0))
        if i < k:
            win.kept[i] = host
        else:
            j = int(rng.integers(i + 1))
            if j < k:
                del win.kept[sorted(win.kept)[j]]
                win.kept[i] = host
        del host
        if _end_of_unit(win, stretch, seconds):
            break
    win.t1 = units[-1].t1
    _finish_trace(win, stretch)
    return win, t_setup


def _finish_trace(win: Window, stretch):
    if stretch is None:
        return
    stretch.stop(len(win.units) - 1)
    # only what lies inside the window: a stretch that starts with it
    # starts in set-up, and one that ends with it stops after its end
    win.paused_s = sum(max(0.0, min(b, win.t1) - max(a, win.t0))
                       for a, b in stretch.pauses)
    if stretch.done:
        win.trace = stretch.summary()
        win.trace_units, win.trace_first = stretch.units, stretch.first
