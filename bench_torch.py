"""Single-GPU benchmark of sep2023_tpu_torch, the port of bench.py's
sections onto the CUDA kernels.  The flagship is the reference's GPU
forward workload (Main-000-Forward-Benchmark.py: 101x201 physical grid ->
165x265 padded, dt=2 ms, nt=1501, 19 shots, 181 receivers, f0=10 Hz,
nPml=32).

    python -m sep2023_tpu_torch bench        (or: python bench_torch.py)

Prints a JSON line
  {"metric": ..., "value": N, "unit": "GCell/s", "vs_baseline": N,
   "extra": {...}}
INCREMENTALLY: the flagship forward's line is printed (and flushed) as soon
as it is measured, and the line is re-printed, extended, after every further
section.  A consumer parses the LAST complete JSON line on stdout.

Each section keeps bench.py's workload (grid, nt, dt, f0, shots, source and
receiver positions, model, wavelet, loss, the arguments it differentiates,
depth and repeats) and runs the port's counterpart of the JAX call there:
`forward_cuda_plan` for the fused and streamed Pallas forwards,
`make_cuda_misfit` and `propagate_cuda_plan` for their gradients,
`propagate_cuda_acoustic_plan` for the acoustic one, and
`propagator.propagate_shots` on the card for the XLA engine's forward (the
plain PyTorch version, `plain_forward`).  GCell/s = nz nx (nt-1) shots / s.
Every kernel section checks, across its calls, that each call added exactly
nt launches a forward and a backward to the launch counters and that no
plain version ran, so no number here is a plain version's but
`plain_forward`'s.

A section that fails raises: the lines already printed stay on stdout and
the command exits non-zero.  Once the elapsed-time budget (env
SEP2023_TPU_BENCH_BUDGET_S, default 2100 s) is spent, the remaining sections
are listed in extra["skipped"] as "<name>: budget" and not run.
SEP2023_TPU_PROFILE=<dir> writes a torch.profiler trace of the card's
activity (no CPU events) to <dir>/bench_torch.trace.json.  extra["device"]
and extra["power_limit"] name the card as nvidia-smi does, extra["peak_GB"]
holds each section's peak of torch.cuda.max_memory_allocated().

vs_baseline is the measured rate over the 1 GCell-updates/s/chip target of
BASELINE.md (the reference publishes no numbers of its own).  Needs one
CUDA device: without one it raises before printing anything.
"""
import contextlib
import json
import os
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from sep2023_tpu_torch import cli, models, parallel, propagator
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine

BUDGET_S = float(os.environ.get("SEP2023_TPU_BENCH_BUDGET_S", "2100"))
BASELINE_GCELL_S = 1.0  # BASELINE.md's target, GCell-updates/s/chip
METRIC = ("2D elastic forward GCell-updates/s/chip (ref workload "
          "165x265x1501x19, CUDA kernels, steady-state)")
F32 = torch.float32

# Every launch counter, by the module that holds it.
COUNTERS = (("LAUNCHES", cuda_engine), ("LAUNCHES_STRIPS", cuda_engine),
            ("LAUNCHES_FIBER", cuda_engine), ("LAUNCHES_BWD", cuda_engine),
            ("LAUNCHES_ILL", cuda_engine), ("LAUNCHES_AC", cuda_acoustic),
            ("LAUNCHES_AC_STRIPS", cuda_acoustic),
            ("LAUNCHES_AC_BWD", cuda_acoustic),
            ("LAUNCHES_AC_IMG", cuda_acoustic))


def forward_launches(cfg):
    """The launches of one elastic forward: nt."""
    return {"LAUNCHES": cfg.nt}


def gradient_launches(cfg, n_chunks=1):
    """The launches of one elastic gradient: a forward with strips and a
    backward, nt each, a shot chunk."""
    n = n_chunks * cfg.nt
    return {"LAUNCHES": n, "LAUNCHES_STRIPS": n, "LAUNCHES_BWD": n}


def acoustic_gradient_launches(cfg):
    """The launches of one acoustic gradient."""
    return {"LAUNCHES_AC": cfg.nt, "LAUNCHES_AC_STRIPS": cfg.nt,
            "LAUNCHES_AC_BWD": cfg.nt}


def _counts():
    return ({name: getattr(m, name) for name, m in COUNTERS},
            dict(cuda_engine.PLAIN_CALLS))


def _fence(out):
    """Wait until the card has run everything queued (bench.py's _fence);
    on the CPU there is nothing to wait for."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def _time(fn, *args, repeats=3):
    """Single-dispatch latency: the best of `repeats` fenced calls, after
    one warm call (a process's first evaluation of a shape pays a
    start-up)."""
    out = _fence(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = _fence(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def _time_pipelined(fn, *args, repeats=2, depth=5):
    """Steady-state throughput: `depth` consecutive calls, one fence,
    divide; the best of `repeats`, after one warm call.  This is how an
    inversion loop runs, so what the host does between calls overlaps the
    card's work unless the path waits for the card inside a call."""
    out = _fence(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(depth):
            out = fn(*args)
        _fence(out)
        best = min(best, (time.perf_counter() - t0) / depth)
    return best, out


def _checked(label, timer, fn, args, per_call, *, plain=None, **kw):
    """timer(fn, *args, **kw), holding fn's calls to their launches: on the
    card each call (the warm one included) adds per_call (counter ->
    launches) to the launch counters and nothing else, and no plain
    version runs but `plain` (a PLAIN_CALLS name, once a call); on the CPU
    nothing launches."""
    calls = 0

    def counted(*a):
        nonlocal calls
        calls += 1
        return fn(*a)

    launches0, plain0 = _counts()
    t, out = timer(counted, *args, **kw)
    launches1, plain1 = _counts()
    on_card = args[0].device.type == "cuda"
    want = {k: v + (calls * per_call.get(k, 0) if on_card else 0)
            for k, v in launches0.items()}
    if launches1 != want:
        raise RuntimeError(f"{label}: launch counters {launches1} after "
                           f"{calls} calls, expected {want}")
    if on_card:
        want_plain = {k: v + (calls if k == plain else 0)
                      for k, v in plain0.items()}
        if plain1 != want_plain:
            raise RuntimeError(f"{label}: plain calls {plain1}, expected "
                               f"{want_plain}")
    return t, out


class Reference(NamedTuple):
    """bench.py's _build, on a device: the reference workload's config,
    survey, geoms, wavelets (S, nt), Medium and (lam, mu, rho), all float32,
    and the plan of its receiver row."""
    cfg: SimConfig
    survey: Survey
    geoms: propagator.ShotGeom
    stf: torch.Tensor
    med: Medium
    lame: tuple
    plan: cuda_engine.FastPlan

    @property
    def cells(self):
        return (self.cfg.nz * self.cfg.nx * (self.cfg.nt - 1)
                * self.survey.n_shots)

    @property
    def src(self):
        n = self.cfg.npml
        return (self.survey.src_z + n, self.survey.src_x + n,
                self.survey.src_rxz)


def _build(device="cuda", nz=101, nx=201, nt=1501, npml=32):
    """bench.py's _build (`cli.benchmark_problem` with the anomaly model of
    `forward`, padded, float32) on `device`; nz, nx, nt, npml other than
    the reference's for small runs."""
    cfg, survey, geoms, stf = cli.benchmark_problem(
        nz=nz, nx=nx, nt=nt, npml=npml, device=device, dtype=F32)
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    pad = lambda a: torch.as_tensor(pad_model_np(a, cfg.npml)).to(device,
                                                                  F32)
    med = Medium(pad(vp), pad(vs), pad(rho))
    n = cfg.npml
    rs = cuda_engine.check_row_survey(survey.rec_z + n, survey.rec_x + n)
    return Reference(cfg, survey, geoms, stf.contiguous(), med,
                     med.to_lame(), cuda_engine.plan_for(cfg, rs))


def sec_flagship(ref):
    """The forward of all shots (bench.py's fused Pallas forward):
    (GCell/s pipelined, its extra keys, the data of a call)."""
    fwd = lambda lam, mu, rho, s: cuda_engine.forward_cuda_plan(  # noqa: E731
        ref.plan, lam, mu, rho, s, *ref.src)
    args = (*ref.lame, ref.stf)
    per_call = forward_launches(ref.cfg)
    t1, data = _checked("forward", _time, fwd, args, per_call)
    t, _ = _checked("forward", _time_pipelined, fwd, args, per_call)
    return ref.cells / t / 1e9, {
        "forward_s": t,
        "forward_single_dispatch_s": t1,
        "single_dispatch_GCell_per_s": ref.cells / t1 / 1e9,
    }, data


def misfit_value_and_grad(cfg, survey, shot_chunk=0):
    """The timed function of the gradient sections: (lam, mu, rho, stf, obs,
    w) -> (loss, d_lam, d_mu, d_rho) of `parallel.make_cuda_misfit`'s loss
    (L2 on ett), bench.py's make_pallas_misfit under jax.grad."""
    loss = parallel.make_cuda_misfit(cfg, survey, shot_chunk=shot_chunk)

    def value_and_grad(lam, mu, rho, stf, obs, w):
        model = tuple(a.detach().requires_grad_() for a in (lam, mu, rho))
        val = loss(*model, stf, obs, w)
        return (val.detach(), *torch.autograd.grad(val, model))

    return value_and_grad


def sec_gradient(ref, data):
    """Misfit and (lam, mu, rho) gradients of all shots, unchunked: all 19
    shots' strips (2.45 GB) are alive at once.  The observed data are the
    flagship's forward of the same model, as in bench.py."""
    w = torch.ones(ref.survey.n_shots, device=data.device, dtype=F32)
    fn = misfit_value_and_grad(ref.cfg, ref.survey, shot_chunk=0)
    t, _ = _checked("gradient", _time_pipelined, fn,
                    (*ref.lame, ref.stf, data, w),
                    gradient_launches(ref.cfg))
    return {"gradient_s": t,
            "gradient_GCell_per_s": ref.cells / t / 1e9}


class StreamProblem(NamedTuple):
    """bench.py's _stream_gcell problem: one shot at z=33 in the middle of
    a homogeneous nz x nx grid, a receiver row at nz-44 from x=42 to
    nx-43."""
    cfg: SimConfig
    plan: cuda_engine.FastPlan
    args: tuple   # lam, mu, rho, stf
    src: tuple    # src_z, src_x, rxz


def stream_problem(nz, nx, nt, *, device="cuda"):
    cfg = SimConfig(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=nt, dt=0.001,
                    f0=10.0, npml=32)
    rs = cuda_engine.RowSurvey(rec_row=nz - 44, rec_x0=42, n_rec=nx - 84)
    vp = torch.full((nz, nx), 3000.0, device=device, dtype=F32)
    lam = vp ** 2 / 3.0 * 2200.0
    mu = vp ** 2 / 3.0 * 2200.0
    rho = torch.full((nz, nx), 2200.0, device=device, dtype=F32)
    stf = torch.as_tensor(ricker(cfg.f0, nt, cfg.dt)).to(device, F32)
    return StreamProblem(cfg, cuda_engine.plan_for(cfg, rs),
                         (lam, mu, rho, stf.expand(1, nt).contiguous()),
                         (np.array([33]), np.array([nx // 2]),
                          np.ones(1, np.float32)))


def stream_gcell(nz, nx, nt, depth=2, *, device="cuda"):
    """bench.py's _stream_gcell: (gradient GCell/s, forward GCell/s) of one
    shot at nz x nx, nt, the gradient that of 1/2 sum syn^2 in (lam, mu,
    rho).  At nt=601 and 1001 no arrival reaches the row, so syn is 0 and
    the backward runs on a zero cotangent, as in bench.py; its launches are
    checked all the same."""
    p = stream_problem(nz, nx, nt, device=device)

    def grad(lam, mu, rho, stf):
        model = tuple(a.detach().requires_grad_() for a in (lam, mu, rho))
        syn = cuda_engine.propagate_cuda_plan(p.plan, *model, stf, *p.src)
        return torch.autograd.grad(0.5 * (syn * syn).sum(), model)

    def fwd(lam, mu, rho, stf):
        return cuda_engine.forward_cuda_plan(p.plan, lam, mu, rho, stf,
                                             *p.src)

    label = f"{nz}x{nx}, nt={nt}"
    t, _ = _checked(f"gradient {label}", _time_pipelined, grad, p.args,
                    gradient_launches(p.cfg), depth=depth)
    t_f, _ = _checked(f"forward {label}", _time_pipelined, fwd, p.args,
                      forward_launches(p.cfg), depth=depth + 1)
    cells = nz * nx * (nt - 1)
    return cells / t / 1e9, cells / t_f / 1e9


def sec_streamed(nz, nx, nt, tag, *, device="cuda", forward=True):
    """A _stream_gcell section's keys: gradient_<tag>_GCell_per_s and,
    with forward, forward_<tag>_GCell_per_s (both are timed either way, as
    in bench.py)."""
    g, f = stream_gcell(nz, nx, nt, device=device)
    out = {f"gradient_{tag}_GCell_per_s": g}
    if forward:
        out[f"forward_{tag}_GCell_per_s"] = f
    return out


def rock_problem(*, device="cuda"):
    """bench.py's rock-physics-scale gradient problem (Main-004's 201x321
    physical grid -> 265x385 padded, nt=4001): one shot at (1, 160),
    receivers on row 190 from x=10 to 310, a homogeneous model, zero
    observed data.  (cfg, survey, lam, mu, rho, stf, obs, w)."""
    cfg = SimConfig(nz=265, nx=385, dz=10.0, dx=10.0, nt=4001, dt=0.001,
                    f0=15.0, npml=32)
    survey = Survey(src_z=np.array([1]), src_x=np.array([160]),
                    rec_z=np.full(301, 190), rec_x=np.arange(10, 311))
    vp = torch.full((cfg.nz, cfg.nx), 3000.0, device=device, dtype=F32)
    med = Medium(vp, vp / torch.tensor(np.sqrt(3.0), dtype=F32),
                 torch.full((cfg.nz, cfg.nx), 2200.0, device=device,
                            dtype=F32))
    stf = torch.as_tensor(ricker(cfg.f0, cfg.nt, cfg.dt)).to(device, F32)
    obs = torch.zeros((1, 4, survey.n_rec, cfg.nt), device=device,
                      dtype=F32)
    w = torch.ones(1, device=device, dtype=F32)
    return (cfg, survey, *med.to_lame(), stf.expand(1, cfg.nt).contiguous(),
            obs, w)


def sec_rock_gradient(prob, depth=3):
    """One shot through the fused backward at the rock-physics scale."""
    cfg, survey, *args = prob
    fn = misfit_value_and_grad(cfg, survey, shot_chunk=0)
    t, _ = _checked("rock gradient", _time_pipelined, fn, args,
                    gradient_launches(cfg), depth=depth)
    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * survey.n_shots
    return {f"rock_gradient_s_{cfg.nz}x{cfg.nx}x{cfg.nt}": t,
            "rock_gradient_GCell_per_s": cells / t / 1e9}


def chunked_problem(nz=265, nx=385, nt=2001, n_shots=12, *, device="cuda"):
    """bench.py's shot-chunked gradient workload (and tools/chunk_bench.py's):
    (cfg, survey, med, stf, obs, w), float32 on `device`."""
    cfg = SimConfig(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=nt, dt=0.001,
                    f0=15.0, npml=32)
    lo, hi = (10, nx - 74) if nx > 120 else (4, nx - 4)  # tiny CPU smokes
    survey = Survey(src_z=np.full(n_shots, 1),
                    src_x=np.linspace(lo, hi - 1, n_shots).astype(int),
                    rec_z=np.full(hi - lo, 1),
                    rec_x=np.arange(lo, hi))
    full = lambda v: torch.full((nz, nx), v, device=device, dtype=F32)
    med = Medium(full(3000.0), full(3000.0 / np.sqrt(3.0)), full(2200.0))
    stf = torch.as_tensor(ricker(cfg.f0, nt, cfg.dt)).to(device, F32)
    obs = torch.zeros((n_shots, 4, survey.n_rec, nt), device=device,
                      dtype=F32)
    w = torch.ones(n_shots, device=device, dtype=F32)
    return cfg, survey, med, stf.expand(n_shots, nt).contiguous(), obs, w


def sec_chunked_gradient(prob, shot_chunk=4, depth=2):
    """Value and gradient of all shots in chunks of shot_chunk through the
    chunked accumulator (`parallel._chunked_sum`: a forward with strips and
    a backward a chunk, one chunk's strips alive at a time)."""
    cfg, survey, med, stf, obs, w = prob
    n_chunks = len(parallel._chunks(survey.n_shots, shot_chunk))
    fn = misfit_value_and_grad(cfg, survey, shot_chunk=shot_chunk)
    t, _ = _checked("chunked gradient", _time_pipelined, fn,
                    (*med.to_lame(), stf, obs, w),
                    gradient_launches(cfg, n_chunks), depth=depth)
    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * survey.n_shots
    return {f"chunked_gradient_GCell_per_s_{survey.n_shots}shot_chunk"
            f"{shot_chunk}": cells / t / 1e9}


def acoustic_value_and_grad(ref):
    """The timed function of the acoustic section: (lam, rho, stf) ->
    (loss, d_lam, d_rho) of 1/2 sum d^2 over the acoustic data of all
    shots, through `propagate_cuda_acoustic_plan` (the kernels compute
    d_stf too, as bench.py notes)."""
    sz, sx, _ = ref.src

    def value_and_grad(lam, rho, stf):
        model = (lam.detach().requires_grad_(), rho.detach().requires_grad_())
        d = cuda_acoustic.propagate_cuda_acoustic_plan(ref.plan, *model, stf,
                                                       sz, sx)
        val = 0.5 * (d * d).sum()
        return (val.detach(), *torch.autograd.grad(val, model))

    return value_and_grad


def sec_acoustic(ref, depth=3):
    """The acoustic gradient at the reference workload, lam = rho 2000^2."""
    rho = ref.med.rho
    t, _ = _checked("acoustic gradient", _time_pipelined,
                    acoustic_value_and_grad(ref),
                    ((rho * 2000.0 ** 2).contiguous(), rho, ref.stf),
                    acoustic_gradient_launches(ref.cfg), depth=depth)
    return {"acoustic_gradient_GCell_per_s": ref.cells / t / 1e9}


def sec_plain_forward(ref):
    """The plain PyTorch forward of all shots on the card, the counterpart
    of bench.py's XLA engine row: no kernel launches, one `propagate` plain
    call a call."""
    @torch.no_grad()
    def fwd(lam, mu, rho, stf):
        return propagator.propagate_shots(ref.cfg, lam, mu, rho, stf,
                                          ref.geoms)

    t, _ = _checked("plain forward", _time, fwd, (*ref.lame, ref.stf), {},
                    plain="propagate")
    return {"plain_forward_s": t,
            "plain_forward_GCell_per_s": ref.cells / t / 1e9}


def _emit(result):
    """(Re-)print the full result line; a consumer parses the LAST complete
    JSON line, so each emit supersedes the previous one."""
    print(json.dumps(result), flush=True)


def run_sections(result, sections, *, budget_s, start, device=None):
    """Print the flagship's line `result`, then run each (name, fn) of
    `sections` in order, merge the keys fn returns into result["extra"] and
    print the whole line again.  A section that raises stops the run: the
    exception propagates and the lines printed so far stay.  Once
    time.monotonic() - start passes budget_s, the remaining sections are
    listed in extra["skipped"] as "<name>: budget" instead.  On a CUDA
    device each section's peak of torch.cuda.max_memory_allocated() goes to
    extra["peak_GB"][name], and its cached memory is released after it."""
    extra = result["extra"]
    cuda = device is not None and torch.device(device).type == "cuda"
    _emit(result)
    for name, fn in sections:
        if time.monotonic() - start > budget_s:
            extra["skipped"].append(f"{name}: budget")
        else:
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            extra.update(fn())
            if cuda:
                extra.setdefault("peak_GB", {})[name] = round(
                    torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
                torch.cuda.empty_cache()
        extra["elapsed_s"] = round(time.monotonic() - start, 1)
        _emit(result)
    return result


def card_identity(device):
    """(name, power limit) of the card as nvidia-smi gives them
    (`--query-gpu=name,power.limit`), for the CUDA device `device`; raises
    if nvidia-smi cannot read them."""
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        gpu, name, limit = (f.strip() for f in line.split(","))
        if gpu.endswith(uuid):
            return name, limit
    raise RuntimeError(f"nvidia-smi lists no GPU with uuid {uuid}: "
                       f"{smi.stdout.strip()!r}")


def sections(ref, data, device):
    """bench.py's sections after the flagship, in its order."""
    return [
        ("gradient", lambda: sec_gradient(ref, data)),
        ("814x2064", lambda: sec_streamed(814, 2064, 601, "814x2064",
                                          device=device)),
        ("rock_gradient",
         lambda: sec_rock_gradient(rock_problem(device=device))),
        ("chunked_gradient",
         lambda: sec_chunked_gradient(chunked_problem(device=device))),
        ("560x720", lambda: sec_streamed(560, 720, 1001, "560x720",
                                         device=device, forward=False)),
        ("acoustic_gradient", lambda: sec_acoustic(ref)),
        ("plain_forward", lambda: sec_plain_forward(ref)),
        ("814x2064_nt1001", lambda: sec_streamed(
            814, 2064, 1001, "814x2064_nt1001", device=device)),
    ]


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("bench needs a CUDA device (an NVIDIA GPU): it "
                           "times the CUDA kernels at sizes where their "
                           "plain versions on the CPU take hours")
    start = time.monotonic()
    device = torch.device("cuda", torch.cuda.current_device())
    name, power_limit = card_identity(device)
    ref = _build(device)
    prof_dir = os.environ.get("SEP2023_TPU_PROFILE")
    profile = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if prof_dir
        else contextlib.nullcontext())
    with profile as prof:
        torch.cuda.reset_peak_memory_stats(device)
        gcell, extra, data = sec_flagship(ref)
        result = {
            "metric": METRIC,
            "value": gcell,
            "unit": "GCell/s",
            "vs_baseline": gcell / BASELINE_GCELL_S,
            "extra": {**extra, "device": name, "power_limit": power_limit,
                      "skipped": [], "peak_GB": {"flagship": round(
                          torch.cuda.max_memory_allocated(device) / 2 ** 30,
                          3)}},
        }
        run_sections(result, sections(ref, data, device), budget_s=BUDGET_S,
                     start=start, device=device)
    if prof_dir:
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir,
                                              "bench_torch.trace.json"))
    return result


if __name__ == "__main__":
    main()
