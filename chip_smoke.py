"""Smoke test of sep2023_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from csrc/, holds each against its plain PyTorch version on the card
(the forward, the forward with boundary strips, the boundary-saving
adjoint, its reconstruction, the adjoint dot product; receiver rows and
point receivers; the reference workload and the large grids 560x720 and
814x2064), drives the main paths through them (`forward` and `invert` at
the reference workload, `invert` at 560x720, a chunked Marmousi-scale
gradient at 814x2064, the curved-fiber inversion of
examples/das_fwi_torch.py), checks the ElasticPropagator API, and prints
the device-time breakdown of a reference forward, a reference gradient, a
reference acoustic gradient and two large-grid gradients (torch.profiler).
The two large main paths are also held against the plain versions at their
own shapes (nt=2001, the main path's survey), and the 54-shot chunk of the
560x720 one, whose strip offsets pass 2^32, against the same shots run
alone, bit for bit.

The acoustic physics the same way: the kernels of csrc/acoustic_fwd.cu and
csrc/acoustic_bwd.cu (the 3-field forward, with and without strips, the
boundary-saving adjoint and its imaging variant) against their plain
versions on AC_CASES, the reference shape and the reference workload
(phase 17); at the shapes of the JAX package's streamed acoustic pair, one
shot at 560x720 and 814x2064 and a 112-shot chunk at 560x720 bit for bit
against single shots (phase 18); and their main paths with exact launch
counts and no plain call (phase 19): `forward --physics acoustic` at the
reference workload and at 560x720 with 64 shots, `rtm` at its defaults,
the acoustic gradient of the JAX package's bench at the reference workload
and at the two streamed shapes, and `rtm --physics elastic`.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits nonzero, printing no result, without
them.  Imports neither jax nor sep2023_tpu.  The last line of standard
output is {"ok": true, "device": {...}}; the line before it is the JSON
record of every kernel (launches on its main path, error, times, bound).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from sep2023_tpu_torch import api, cli, das, models, parallel
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import _build, cuda_acoustic, cuda_engine
from sep2023_tpu_torch.ops import signal as sg
from sep2023_tpu_torch.ops.misfit import l2_misfit
from sep2023_tpu_torch.testing import (AC_CASES, AC_INTERIOR, DOT_TOL,
                                       FIBER_CASES, GRAD_TOL, RECON_RATIO,
                                       ROW_CASES, ac_perturbed_cotangent,
                                       ac_problem, ac_row_problem,
                                       acoustic_args, adjoint_gap,
                                       fiber_problem, grad_errors,
                                       perturbed_cotangent,
                                       reconstruction_residual, row_problem,
                                       strip_errors)
from sep2023_tpu_torch.testing import max_rel as rel_err

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "examples"))
import das_fwi_torch  # noqa: E402  (examples/das_fwi_torch.py)

TOL = 2e-5          # per channel, relative to the channel max (f32 kernel
                    # vs f32 plain; the JAX package's Pallas-vs-XLA bound)
TOL_LONG = 1e-4     # nt=1501: FMA contraction and summation order differ,
                    # and the rounding differences accumulate over 1500 steps

# The least time the card could take (bound_ms): the larger of the FP32
# operations over the H100 SXM's 67 TFLOP/s FP32 peak outside the tensor
# cores and the bytes (each input read once, each output written once) over
# its 3.35 TB/s (NVIDIA's data sheet).  Operations per cell and step,
# counted in the sources (a multiply, an add or a subtract is one; the
# shared code of elastic_common.cuh rounds each and contracts none):
#   elastic_fwd.cu: stress 54 (4 stencils x 5, 4 CPML derivatives x 5,
#     increments 11, 3 field adds), velocity 48 (20 + 20, increments 6,
#     2 adds): 102;
#   elastic_bwd.cu: velocity launch 100 (4 transposed stencils and their
#     sums 24, 4 stencils 20, reconstruction 12, buoyancy cotangents and
#     gradients 24, 4 CPML adjoints x 5), stress launch 115 (24, 20,
#     reconstruction 18, elastic cotangents and gradients 33, 20): 215;
#   acoustic_fwd.cu: pressure 24 (2 stencils x 5, 2 CPML derivatives x 5,
#     increment 3, 1 field add), velocity 26 (10 + 10, increments 4,
#     2 adds): 50;
#   acoustic_bwd.cu: velocity launch 56 (2 transposed stencils and their
#     sums 12, 2 stencils 10, reconstruction 8, buoyancy cotangents and
#     gradients 16, 2 CPML adjoints x 5), pressure launch 49 (12, 10,
#     reconstruction 6, cotangent and gradient of lam 11, 10): 105; as the
#     imaging variant 102 (the 9 of the three gradients give way to the 6 of
#     the image and the illumination).
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
FWD_OPS_PER_CELL_STEP = 102
BWD_OPS_PER_CELL_STEP = 215
AC_FWD_OPS_PER_CELL_STEP = 50
AC_BWD_OPS_PER_CELL_STEP = 105
AC_IMG_OPS_PER_CELL_STEP = 102


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def max_rel(out, ref):
    """Per-channel max |out - ref| / max |ref|, and the max absolute error."""
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    check(np.isfinite(out).all(), "kernel output not finite")
    rel = [float(np.abs(out[:, c] - ref[:, c]).max() / np.abs(ref[:, c]).max())
           for c in range(4)]
    return rel, float(np.abs(out - ref).max())


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of fn() over reps runs, CUDA events, after one
    warm-up run (warm=False where the caller has just run fn)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Every launch counter, by the module that holds it.
COUNTERS = {"LAUNCHES": cuda_engine, "LAUNCHES_STRIPS": cuda_engine,
            "LAUNCHES_FIBER": cuda_engine, "LAUNCHES_BWD": cuda_engine,
            "LAUNCHES_BWD_FIBER": cuda_engine, "LAUNCHES_AC": cuda_acoustic,
            "LAUNCHES_AC_STRIPS": cuda_acoustic,
            "LAUNCHES_AC_BWD": cuda_acoustic,
            "LAUNCHES_AC_IMG": cuda_acoustic}


def reset_counts():
    """Set every launch counter and every plain-call count to 0."""
    for k, module in COUNTERS.items():
        setattr(module, k, 0)
    for k in cuda_engine.PLAIN_CALLS:
        cuda_engine.PLAIN_CALLS[k] = 0


def read_counts():
    """(launch counters by name, plain calls by name) since reset_counts."""
    return ({k: getattr(module, k) for k, module in COUNTERS.items()},
            dict(cuda_engine.PLAIN_CALLS))


def counts_are(got, want):
    """The launch counters equal `want` (a name missing there must be 0)."""
    return got == {k: want.get(k, 0) for k in COUNTERS}


def check_counts(label, got, want, plain_calls):
    """The launch counters equal `want` (a name missing there must be 0)
    and no plain version ran."""
    check(counts_are(got, want), f"{label}: launches {got}, expected {want}")
    check(sum(plain_calls.values()) == 0,
          f"{label} called the plain versions: {plain_calls}")


def _reference(dev, nz, nx, grid):
    """(cfg, RowSurvey, Medium, stf, geoms) of cli.benchmark_problem with
    the true model of `forward` and `invert`."""
    cfg, survey, geoms, stf = cli.benchmark_problem(nz=nz, nx=nx, **grid,
                                                    device=dev)
    stf = (stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=dev)
           ).contiguous()
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    t = lambda a: torch.as_tensor(pad_model_np(a, cfg.npml), device=dev).to(
        torch.float32)
    rs = cuda_engine.check_row_survey(survey.rec_z + cfg.npml,
                                      survey.rec_x + cfg.npml)
    return cfg, rs, Medium(t(vp), t(vs), t(rho)), stf, geoms


def reference_problem(dev, nz=101, nx=201, **grid):
    """The inputs `forward` and `invert` build for their true model, at
    their defaults (101x201 + npml 32, nt=1501, 19 shots, 181 receivers at
    z=95) or at another grid of cli.benchmark_problem."""
    cfg, rs, med, stf, geoms = _reference(dev, nz, nx, grid)
    lam, mu, rho = med.to_lame()
    return cfg, rs, (lam, mu, rho, stf, geoms.src_z, geoms.src_x, geoms.rxz)


def acoustic_reference_problem(dev, nz=101, nx=201, vp=None, **grid):
    """The inputs `forward --physics acoustic` builds (lam = rho vp^2 of the
    same true model), or with a constant vp those of the JAX package's
    bench (bench.py sec_acoustic: lam = rho 2000^2): (cfg, rs, (lam, rho,
    stf, src_z, src_x))."""
    cfg, rs, med, stf, geoms = _reference(dev, nz, nx, grid)
    lam = med.rho * (med.vp if vp is None else vp) ** 2
    return cfg, rs, (lam.contiguous(), med.rho.contiguous(), stf,
                     geoms.src_z, geoms.src_x)


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"[1 environment] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}; nvcc: {nvcc[-1]}")


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {path}")
    # ptxas -v: "Function properties for <mangled name>", then "Used N
    # registers, ..." for that kernel
    name = None
    for line in _build.build_log(path).read_text().splitlines():
        m = re.search(r"Function properties for .*?(?<=\d)([a-z_]+_kernel)E",
                      line)
        if m:
            name = m.group(1)
        elif "Used" in line and name:
            print(f"[2 build] {name}: {line.split(':', 1)[1].strip()}")
            name = None


def phase_kernel_vs_plain(dev):
    for name, args in ROW_CASES.items():
        cfg, rs, inputs = row_problem(*args, device=dev)
        plan = cuda_engine.plan_for(cfg, rs)
        ref = cuda_engine.forward_plain(cfg, rs, *inputs)
        ett = float(ref[:, 3].abs().max())
        check(ett > 1e-3, f"{name}: no arrivals at the receivers ({ett})")
        rel, _ = max_rel(cuda_engine.forward_cuda_plan(plan, *inputs), ref)
        check(max(rel) < TOL, f"{name}: kernel vs plain {rel} >= {TOL}")
        print(f"[3 kernel vs plain] {name} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, "
              f"{inputs[3].shape[0]} shots): max rel err per channel "
              f"{rel} < {TOL}, max |ett| {ett:.6e}")

    cfg, rs, inputs = reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    out = cuda_engine.forward_cuda_plan(plan, *inputs)
    ref = cuda_engine.forward_plain(cfg, rs, *inputs)
    rel, abs_err = max_rel(out, ref)
    check(max(rel) < TOL_LONG, f"reference workload: {rel} >= {TOL_LONG}")
    kernel_ms = cuda_ms(
        lambda: cuda_engine.forward_cuda_plan(plan, *inputs), 5)
    plain_ms = cuda_ms(lambda: cuda_engine.forward_plain(cfg, rs, *inputs), 1,
                       warm=False)
    print(f"[3 kernel vs plain] reference workload ({cfg.nz}x{cfg.nx}, "
          f"nt={cfg.nt}, 19 shots): max rel err per channel {rel} < "
          f"{TOL_LONG}, max abs err {abs_err}; per forward, CUDA events: "
          f"kernel {kernel_ms:.3f} ms (mean of 5), plain {plain_ms:.3f} ms "
          f"(1 run after the comparison's)")
    return abs_err, kernel_ms, plain_ms, max(rel)


def phase_main_path(plain_ms):
    with tempfile.TemporaryDirectory() as d:
        cuda_engine.LAUNCHES = 0
        data = cli.main(["forward", "--data-dir", d])
        launches = cuda_engine.LAUNCHES
        check(launches >= 3 * 1500,
              f"forward launched the kernel {launches} times, < 4500")
        check(data.device.type == "cuda", "forward did not run on the card")
        out = data.cpu().numpy()
        check(out.shape == (19, 4, 181, 1501), f"data shape {out.shape}")
        check(np.isfinite(out).all(), "forward data not finite")
        ett = float(np.abs(out[:, 3]).max())
        check(ett > 0, "ett channel is zero")
        n_files = len([f for f in os.listdir(d) if f.startswith("Shot_")])
        check(n_files == 19 * 4, f"{n_files} Shot files, not 76")
        back = sio.read_shots(d, 19, 181, 1501)
        check(np.array_equal(back, out), "Shot files differ from the data")
    print(f"[4 main path] forward: {launches} kernel launches, data "
          f"{out.shape} finite, max |ett| {ett:.6e}, 76 Shot files read "
          f"back equal")
    cells = 165 * 265 * 1500 * 19
    print(f"[4 main path] the same forward in plain PyTorch on the card, "
          f"phase 3's CUDA-event time: {plain_ms:.3f} ms, "
          f"{cells / plain_ms / 1e6:.2f} GCell/s")
    return launches


def phase_api(dev):
    nz, nx = 44, 60
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    model = api.Model(nx=nx, nz=nz, dx=20.0, dz=20.0, nt=260, dt=0.002,
                      nPml=10, vp=vp, vs=vs, rho=rho)
    survey = Survey(src_z=np.array([1, 1]), src_x=np.array([15, 45]),
                    rec_z=np.full(40, 38), rec_x=np.arange(10, 50))
    before = cuda_engine.LAUNCHES
    out = api.ElasticPropagator(model, survey, device=dev).apply_forward()
    check(cuda_engine.LAUNCHES > before, "apply_forward skipped the kernel")
    ref = api.ElasticPropagator(model, survey, device="cpu").apply_forward()
    rel, _ = max_rel(torch.from_numpy(out), torch.from_numpy(ref))
    check(max(rel) < TOL, f"apply_forward vs plain {rel} >= {TOL}")
    print(f"[5 api] ElasticPropagator(device='cuda').apply_forward() "
          f"{out.shape} vs plain: max rel err per channel {rel} < {TOL}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(cfg, S, ops_per_cell_step, n_bytes):
    """(bound_ms, bound_by) of work over S shots of cfg's grid."""
    ops = ops_per_cell_step * cfg.nz * cfg.nx * (cfg.nt - 1) * S
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_strips_vs_plain(dev):
    """K1 with strip saving against forward_plain_strips: data per channel,
    strips and final fields per field."""
    for name, args in ROW_CASES.items():
        cfg, rs, inputs = row_problem(*args, device=dev)
        out = cuda_engine.forward_cuda_plan(cuda_engine.plan_for(cfg, rs),
                                            *inputs, save_strips=True)
        ref = cuda_engine.forward_plain_strips(cfg, rs, *inputs)
        d, s, f = strip_errors(out, ref)
        check(max(d + s + f) < TOL,
              f"{name}: strips kernel vs plain {d} {s} {f} >= {TOL}")
        print(f"[7 strips vs plain] {name} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}):"
              f" max rel err data per channel {d}, strips per field {s}, "
              f"final fields per field {f} < {TOL}")

    cfg, rs, inputs = reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    out = cuda_engine.forward_cuda_plan(plan, *inputs, save_strips=True)
    ref = cuda_engine.forward_plain_strips(cfg, rs, *inputs)
    d, s, f = strip_errors(out, ref)
    check(max(d + s + f) < TOL_LONG,
          f"reference workload: strips {d} {s} {f} >= {TOL_LONG}")
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    n_bytes = nbytes(*inputs[:4], *out)
    del out, ref
    kernel_ms = cuda_ms(lambda: cuda_engine.forward_cuda_plan(
        plan, *inputs, save_strips=True), 5)
    plain_ms = cuda_ms(lambda: cuda_engine.forward_plain_strips(
        cfg, rs, *inputs), 1, warm=False)
    b_ms, b_by = bound(cfg, inputs[3].shape[0], FWD_OPS_PER_CELL_STEP,
                       n_bytes)
    print(f"[7 strips vs plain] reference workload ({cfg.nz}x{cfg.nx}, "
          f"nt={cfg.nt}, 19 shots): max rel err data {d}, strips {s}, final "
          f"{f} < {TOL_LONG}, max abs err {abs_err}; per forward with "
          f"strips, CUDA events: kernel {kernel_ms:.3f} ms (mean of 5), plain "
          f"{plain_ms:.3f} ms (1 run after the comparison's); bound "
          f"{b_ms:.3f} ms ({b_by}, {n_bytes / 1e9:.3f} GB)")
    return dict(max_abs_err=abs_err, max_rel_err=max(d + s + f), ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def _backward_pair(cfg, rs, inputs):
    """backward_cuda_plan and backward_plain fed the same strips, final
    fields and cotangent (the L2 residual of a model with lam raised by
    3%)."""
    plan = cuda_engine.plan_for(cfg, rs)
    syn, strips, final = cuda_engine.forward_cuda_plan(plan, *inputs,
                                                       save_strips=True)
    ett = float(syn[:, 3].abs().max())
    check(ett > 1e-3, f"no arrivals at the receivers ({ett})")
    d = perturbed_cotangent(cfg, rs, inputs, syn)
    check(float(d.abs().max()) > 1e-3 * ett, "the cotangent is round-off")
    res = (*inputs, final, strips, d)
    return res, cuda_engine.backward_cuda_plan(plan, *res), \
        cuda_engine.backward_plain(cfg, rs, *res), ett


def phase_backward_vs_plain(dev):
    """K2 against backward_plain: d_lam, d_mu, d_rho (interior less
    GRAD_MARGIN) and d_stf, each relative to its max abs."""
    for name, args in ROW_CASES.items():
        cfg, rs, inputs = row_problem(*args, device=dev)
        _, out, ref, ett = _backward_pair(cfg, rs, inputs)
        err = grad_errors(out, ref, cfg)
        check(max(err) < GRAD_TOL,
              f"{name}: backward kernel vs plain {err} >= {GRAD_TOL}")
        print(f"[8 backward vs plain] {name} ({cfg.nz}x{cfg.nx}, "
              f"nt={cfg.nt}): max rel err (d_lam, d_mu, d_rho, d_stf) {err} "
              f"< {GRAD_TOL}, max |ett| {ett:.6e}")

    cfg, rs, inputs = reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    res, out, ref, ett = _backward_pair(cfg, rs, inputs)
    err = grad_errors(out, ref, cfg)
    check(max(err) < GRAD_TOL, f"reference workload: {err} >= {GRAD_TOL}")
    again = cuda_engine.backward_cuda_plan(plan, *res)
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "a second backward run gave other bits")
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    n_bytes = nbytes(*res[:4], *res[7:], *out)
    del again
    del out, ref
    kernel_ms = cuda_ms(lambda: cuda_engine.backward_cuda_plan(plan, *res),
                        3)
    plain_ms = cuda_ms(lambda: cuda_engine.backward_plain(cfg, rs, *res), 1,
                       warm=False)
    b_ms, b_by = bound(cfg, inputs[3].shape[0], BWD_OPS_PER_CELL_STEP,
                       n_bytes)
    print(f"[8 backward vs plain] reference workload ({cfg.nz}x{cfg.nx}, "
          f"nt={cfg.nt}, 19 shots): max rel err (d_lam, d_mu, d_rho, d_stf) "
          f"{err} < {GRAD_TOL}, max abs err {abs_err}, max |ett| {ett:.6e}, "
          f"a second run bitwise equal;"
          f" per backward, CUDA events: kernel {kernel_ms:.3f} ms (mean of 3),"
          f" plain {plain_ms:.3f} ms (1 run after the comparison's); bound "
          f"{b_ms:.3f} ms ({b_by}, {n_bytes / 1e9:.3f} GB)")
    return dict(max_abs_err=abs_err, max_rel_err=max(err), ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def phase_adjoint_dot(dev):
    for name in ("small exx", "small ezz", "reference shape nt=301"):
        cfg, rs, inputs = row_problem(*ROW_CASES[name], device=dev)
        lhs, rhs, gap = adjoint_gap(cfg, rs, inputs)
        check(gap <= DOT_TOL, f"{name}: adjoint gap {gap} > {DOT_TOL}")
        print(f"[9 adjoint dot] {name}: <d, J s> {lhs:.9e}, <J^T d, s> "
              f"{rhs:.9e}, relative gap {gap:.3e} <= {DOT_TOL}")


def phase_reconstruction(dev):
    """K2's reconstruction alone, the reference workload back to t=0, and
    the plain f32 reconstruction from the same final fields and strips."""
    cfg, rs, inputs = reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    data, strips, final = cuda_engine.forward_cuda_plan(plan, *inputs,
                                                        save_strips=True)
    kern = reconstruction_residual(cfg, cuda_engine.reconstruct_cuda_plan(
        plan, *inputs, final, strips), data)
    plain = reconstruction_residual(cfg, cuda_engine.reconstruct_plain(
        cfg, rs, *inputs, final, strips), data)
    check(np.isfinite(kern) and kern <= RECON_RATIO * plain,
          f"reconstruction residual {kern} > {RECON_RATIO} x plain {plain}")
    print(f"[10 reconstruction] reference workload back to t=0: interior "
          f"stress residual / peak |pr|: kernel {kern:.6e}, plain f32 "
          f"{plain:.6e} (kernel <= {RECON_RATIO:g} x plain)")


def _invert(label, argv, S, steps, niter):
    """`invert` through cli.main with the counts set to 0 just before and
    read just after: the loss decreases, the launch counts are exact, no
    plain version ran.  Returns (counts, summary, loss values)."""
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = cli.main(["invert", *argv, "--niter", str(niter),
                        "--exp-name", d])
        counts, plain_calls = read_counts()
        hist = np.loadtxt(os.path.join(d, "Results", "loss.txt"), ndmin=2)
    n = out["n_evals"]
    chunks = len(parallel._chunks(S, out["shot_chunk"]))
    # the twin data: one forward a chunk; an evaluation: a forward with
    # strips and a backward a chunk
    want = {"LAUNCHES": 3 * steps * chunks * (1 + n),
            "LAUNCHES_STRIPS": 3 * steps * chunks * n,
            "LAUNCHES_BWD": (2 * steps + 1) * chunks * n}
    check_counts(label, counts, want, plain_calls)
    loss = hist[:, 1]
    check(len(loss) == niter and np.isfinite(loss).all()
          and (np.diff(loss) < 0).all(), f"loss.txt not decreasing: {loss}")
    print(f"{label} loss.txt {loss.tolist()} decreasing; {n} gradient "
          f"evaluations in {chunks} shot chunk(s) of {S} shots; launches = "
          f"forward 3 x {steps} x {chunks} x (1 + {n}) = "
          f"{counts['LAUNCHES']} (with strips {counts['LAUNCHES_STRIPS']}),"
          f" backward (2 x {steps} + 1) x {chunks} x {n} = "
          f"{counts['LAUNCHES_BWD']}, as expected; plain calls "
          f"{plain_calls}")
    return counts, out, n, chunks


def phase_invert_main_path():
    """`invert --niter 3` at the CLI defaults (the reference workload)."""
    counts, out, n, _ = _invert("[11 main path] invert --niter 3:", [], 19,
                                1500, 3)
    per_eval = out["seconds"] / n
    cells = 165 * 265 * 1500 * 19
    print(f"[11 main path] {out['seconds']:.3f} s in L-BFGS-B, "
          f"{per_eval:.3f} s per gradient evaluation, "
          f"{cells / per_eval / 1e9:.2f} GCell/s gradient")
    return counts


def _fiber_case(label, cfg, rs, inputs):
    """Point receivers: the forward, the forward with strips and the
    backward against their plain versions, a second backward bitwise, the
    adjoint dot product, and the launch counters of each call."""
    steps = cfg.nt - 1
    plan = cuda_engine.plan_for(cfg, rs)
    reset_counts()
    out = cuda_engine.forward_cuda_plan(plan, *inputs, save_strips=True)
    data = cuda_engine.forward_cuda_plan(plan, *inputs)
    counts, _ = read_counts()
    check(counts_are(counts, {"LAUNCHES": 6 * steps,
                              "LAUNCHES_STRIPS": 3 * steps,
                              "LAUNCHES_FIBER": 2 * steps}),
          f"{label}: forward launch counters {counts}")
    check(torch.equal(data, out[0]), f"{label}: strip saving changed the data")
    ref = cuda_engine.forward_plain_strips(cfg, rs, *inputs)
    d, s, f = strip_errors(out, ref)
    check(max(d + s + f) < TOL, f"{label}: kernel vs plain {d} {s} {f}")
    ett = float(ref[0][:, 3].abs().max())
    check(ett > 1e-3, f"{label}: no arrivals at the receivers ({ett})")
    del out, ref, data
    res, g, g_ref, _ = _backward_pair(cfg, rs, inputs)
    err = grad_errors(g, g_ref, cfg)
    check(max(err) < GRAD_TOL, f"{label}: backward vs plain {err}")
    reset_counts()
    again = cuda_engine.backward_cuda_plan(plan, *res)
    counts, _ = read_counts()
    check(counts["LAUNCHES_BWD"] == 3 * steps + 1
          and counts["LAUNCHES_BWD_FIBER"] == steps,
          f"{label}: backward launch counters {counts}")
    check(all(torch.equal(a, b) for a, b in zip(g, again)),
          f"{label}: a second backward run gave other bits")
    _, _, gap = adjoint_gap(cfg, rs, inputs)
    check(gap <= DOT_TOL, f"{label}: adjoint gap {gap} > {DOT_TOL}")
    print(f"[12 fiber vs plain] {label} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, "
          f"{rs.n_rec} points, {cfg.das_channel}): max rel err data per "
          f"channel {d}, strips {max(s)}, final fields {max(f)} < {TOL}; "
          f"(d_lam, d_mu, d_rho, d_stf) {err} < {GRAD_TOL}; adjoint gap "
          f"{gap:.3e} <= {DOT_TOL}; a second backward bitwise equal; "
          f"launches a forward 3 x {steps} (record_points {steps}), a "
          f"backward 3 x {steps} + 1 (inject_points {steps}); max |ett| "
          f"{ett:.6e}")


def das_fwi_problem(dev):
    """The acquisition of examples/das_fwi_torch.py with the inputs its
    first evaluation passes: (cfg, FiberSurvey, inputs)."""
    cfg, survey, das_w, _ = das_fwi_torch.acquisition()
    n = cfg.npml
    vp, vs, rho = models.anomaly_vp_vs_rho(cfg.nz - 2 * n, cfg.nx - 2 * n)
    t = lambda a: torch.as_tensor(pad_model_np(a, n), device=dev).to(
        torch.float32)
    lam, mu, rho = Medium(t(models.smooth(vp, 6.0)), t(vs), t(rho)).to_lame()
    stf = torch.as_tensor(ricker(cfg.f0, cfg.nt, cfg.dt), device=dev).to(
        torch.float32).expand(survey.n_shots, cfg.nt).contiguous()
    plan, _ = parallel._cuda_plan(cfg, survey, das_w)
    return cfg, plan.rs, (lam.contiguous(), mu.contiguous(),
                          rho.contiguous(), stf, survey.src_z + n,
                          survey.src_x + n, survey.src_rxz)


def phase_fiber_vs_plain(dev):
    """K1-fiber: record_points_kernel and inject_points_kernel against the
    plain versions on every FIBER_CASES problem and at the shapes of the
    fiber main path (examples/das_fwi_torch.py), where they are also timed:
    returns that case's (forward, backward) numbers."""
    for name in FIBER_CASES:
        _fiber_case(name, *fiber_problem(name, device=dev))
    problem = das_fwi_problem(dev)
    _fiber_case("das_fwi_torch shapes", *problem)
    return hold_against_plain("[12 fiber vs plain] das_fwi_torch shapes",
                              *problem, TOL, silent_samples=0)


# Large grids, the shapes of the JAX package's streamed pair (bench.py
# _stream_gcell: homogeneous vp 3000 m/s, 10 m cells, npml 32, 1 ms, 10 Hz,
# one shot at (33, nx/2)).  The receiver row lies LARGE_ROW_DEPTH cells under
# the source, not on row nz-44 as there: at nt=1001 and nt=601 the wave does
# not reach that row, and a comparison of silent recordings and of the zero
# gradient they give holds nothing.
LARGE_CASES = {
    "560x720 row": (560, 720, 1001, "row"),
    "814x2064 row": (814, 2064, 601, "row"),
    "560x720 weighted spline fiber": (560, 720, 1001, "fiber"),
}
LARGE_ROW_DEPTH = {1001: 150, 601: 90}


def large_problem(nz, nx, nt, kind, dev):
    """(cfg, survey, inputs) of a LARGE_CASES case."""
    npml = 32
    cfg = SimConfig(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=nt, dt=0.001, f0=10.0,
                    npml=npml,
                    das_channel="weighted" if kind == "fiber" else "exx")
    full = lambda v: torch.full((nz, nx), v, device=dev, dtype=torch.float32)
    lam = mu = full(3000.0 ** 2 / 3.0 * 2200.0)
    stf = torch.as_tensor(ricker(cfg.f0, nt, cfg.dt), device=dev).to(
        torch.float32).reshape(1, nt).contiguous()
    if kind == "row":
        rs = cuda_engine.RowSurvey(33 + LARGE_ROW_DEPTH[nt], 42, nx - 84)
    else:
        # a spline cable as in examples/overthrust_das.py, scaled to this
        # grid: 400 points, 0.9 to 1.6 km deep across 5.5 km
        cp = np.array([[500.0, 1200.0, 0.0], [1900.0, 900.0, 0.0],
                       [3300.0, 1600.0, 0.0], [4700.0, 1000.0, 0.0],
                       [6000.0, 1400.0, 0.0]])
        rec_z, rec_x, das_w = das.cable_to_receivers(
            das.spline_fiber(cp, npts=400), cfg.dx, cfg.dz)
        rs = cuda_engine.plan_fast_path(cfg, rec_z + npml, rec_x + npml,
                                        das_w=das_w).rs
    return cfg, rs, (lam, mu, full(2200.0), stf, np.array([33]),
                     np.array([nx // 2]), np.ones(1))


def _timed(fn):
    """(fn(), its milliseconds by CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


class Engine(NamedTuple):
    """What hold_against_plain and chunk_against_single_shots need of the
    elastic or the acoustic pair of kernels.  Inputs are n_model material
    planes, the wavelets, then the source tables."""
    kind: str
    n_model: int          # lam, mu, rho or lam, rho
    n_fields: int
    n_state: int          # planes of the forward's state buffer
    arrival_channel: int  # ett, or the acoustic pr
    grads: str
    interior: int         # cells between the PML and the kept gradients
    acoustic: bool
    fwd_ops: int
    bwd_ops: int
    forward: object
    backward: object
    reconstruct: object
    plain_forward_strips: object
    plain_backward: object
    plain_reconstruct: object


ELASTIC = Engine(
    "elastic", 3, 5, cuda_engine.N_STATE_PLANES, 3,
    "(d_lam, d_mu, d_rho, d_stf)", 0, False, FWD_OPS_PER_CELL_STEP,
    BWD_OPS_PER_CELL_STEP, cuda_engine.forward_cuda_plan,
    cuda_engine.backward_cuda_plan, cuda_engine.reconstruct_cuda_plan,
    cuda_engine.forward_plain_strips, cuda_engine.backward_plain,
    cuda_engine.reconstruct_plain)
ACOUSTIC = Engine(
    "acoustic", 2, 3, cuda_acoustic.N_STATE_PLANES, 0,
    "(d_lam, d_rho, d_stf)", AC_INTERIOR, True, AC_FWD_OPS_PER_CELL_STEP,
    AC_BWD_OPS_PER_CELL_STEP, cuda_acoustic.forward_cuda_acoustic_plan,
    cuda_acoustic.backward_cuda_acoustic_plan,
    cuda_acoustic.reconstruct_cuda_acoustic_plan,
    cuda_acoustic.forward_plain_acoustic_strips,
    cuda_acoustic.backward_plain_acoustic,
    cuda_acoustic.reconstruct_plain_acoustic)


def assumed_bytes(cfg, shots, eng=ELASTIC):
    """What auto_shot_chunk assumes `shots` shots in flight hold."""
    return shots * (parallel.strip_bytes_per_shot(cfg, eng.acoustic)
                    + parallel.state_bytes_per_shot(cfg, eng.acoustic))


def hold_against_plain(tag, cfg, rs, inputs, tol, silent_samples=20,
                       eng=ELASTIC):
    """All the shots of `inputs` through K1-strips and K2 (with point
    receivers: K1-fiber; with eng=ACOUSTIC: K5-strips and K6) against their
    plain versions: data (`tol`), strips and final fields (TOL), gradients
    (GRAD_TOL), a second backward bitwise, the
    reconstruction residual, CUDA-event times, bounds and peak memory.  The
    cotangent is the data itself (the loss 0.5 sum(syn^2) of bench.py's
    large-grid cells).  The kernels' times are means of 3 runs; each plain
    version runs once, for the comparison, and that run is the one timed.
    Returns the (forward, backward) numbers of the kernels line."""
    stf = inputs[eng.n_model]
    S = stf.shape[0]
    plan = cuda_engine.plan_for(cfg, rs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = eng.forward(plan, *inputs, save_strips=True)
    data, strips, final = out
    d_data = data.clone()
    res = (*inputs, final, strips, d_data)
    g = eng.backward(plan, *res)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assumed = assumed_bytes(cfg, S, eng)
    ett = data[:, eng.arrival_channel].abs()
    check(float(ett.max()) > 1e-6, f"{tag} no arrivals at the receivers")
    if silent_samples:  # and the receivers are far enough to see it arrive
        check(float(ett[..., :silent_samples].max())
              < 1e-6 * float(ett.max()), f"{tag} arrivals from sample 0")

    ref, fwd_plain = _timed(lambda: eng.plain_forward_strips(cfg, rs,
                                                             *inputs))
    d, s, f = strip_errors(out, ref)
    check(max(d) < tol and max(s + f) < TOL,
          f"{tag} forward vs plain {d} {s} {f}")
    fwd_abs = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    del ref
    g_ref, bwd_plain = _timed(lambda: eng.plain_backward(cfg, rs, *res))
    err = grad_errors(g, g_ref, cfg, eng.interior)
    check(all(np.isfinite(err)) and max(err) < GRAD_TOL,
          f"{tag} backward vs plain {err}")
    check(all(float(a.abs().max()) > 0 for a in g_ref), f"{tag} a plain "
          "gradient is zero")
    bwd_abs = max(float((a - b).abs().max()) for a, b in zip(g, g_ref))
    again = eng.backward(plan, *res)
    check(all(torch.equal(a, b) for a, b in zip(g, again)),
          f"{tag} a second backward run gave other bits")
    fwd_bytes = nbytes(*inputs[:eng.n_model + 1], *out)
    bwd_bytes = nbytes(*inputs[:eng.n_model + 1], final, strips, d_data, *g)
    del again, g_ref

    kern = reconstruction_residual(cfg, eng.reconstruct(
        plan, *inputs, final, strips), data)
    plain = reconstruction_residual(cfg, eng.plain_reconstruct(
        cfg, rs, *inputs, final, strips), data)
    check(np.isfinite(kern) and kern <= RECON_RATIO * plain,
          f"{tag} reconstruction residual {kern} > {RECON_RATIO} x {plain}")

    fwd_ms = cuda_ms(lambda: eng.forward(plan, *inputs, save_strips=True), 3)
    bwd_ms = cuda_ms(lambda: eng.backward(plan, *res), 3)
    fb, fb_by = bound(cfg, S, eng.fwd_ops, fwd_bytes)
    bb, bb_by = bound(cfg, S, eng.bwd_ops, bwd_bytes)
    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * S
    print(f"{tag} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, {S} shot(s), {rs.n_rec} "
          f"receivers, {eng.kind}): forward with strips vs plain: max rel "
          f"err data {d} < {tol}, strips {max(s)}, final {max(f)} < {TOL}; "
          f"gradients {eng.grads} {err} < {GRAD_TOL}, a second backward "
          f"bitwise equal; reconstruction residual / peak |pr| kernel "
          f"{kern:.6e}, plain f32 {plain:.6e}; max |"
          f"{'pr' if eng.acoustic else 'ett'}| {float(ett.max()):.6e}")
    print(f"{tag} CUDA events: forward with strips kernel {fwd_ms:.3f} ms "
          f"(mean of 3, {cells / fwd_ms / 1e6:.2f} GCell/s), plain "
          f"{fwd_plain:.3f} ms (the comparison's run), bound {fb:.3f} ms "
          f"({fb_by}, {fwd_bytes / 1e9:.3f} GB); backward kernel "
          f"{bwd_ms:.3f} ms (mean of 3, {cells / bwd_ms / 1e6:.2f} GCell/s), "
          f"plain {bwd_plain:.3f} ms (the comparison's run), bound {bb:.3f} "
          f"ms ({bb_by}, {bwd_bytes / 1e9:.3f} GB); forward + backward "
          f"{cells / (fwd_ms + bwd_ms) / 1e6:.2f} GCell/s; peak memory of "
          f"one forward with strips and one backward {peak / 1e9:.3f} GB, "
          f"auto_shot_chunk assumes {assumed / 1e9:.3f} GB for {S} shot(s)")
    return (dict(max_abs_err=fwd_abs, max_rel_err=max(d + s + f), ms=fwd_ms,
                 plain_ms=fwd_plain, bound_ms=fb, bound_by=fb_by),
            dict(max_abs_err=bwd_abs, max_rel_err=max(err), ms=bwd_ms,
                 plain_ms=bwd_plain, bound_ms=bb, bound_by=bb_by))


def phase_large_vs_plain(dev):
    """One shot on each LARGE_CASES problem against the plain versions."""
    for name, (nz, nx, nt, kind) in LARGE_CASES.items():
        hold_against_plain(f"[13 large grid vs plain] {name}",
                           *large_problem(nz, nx, nt, kind, dev), TOL_LONG)
        torch.cuda.empty_cache()


def _shots(inputs, a, b, eng=ELASTIC):
    """The inputs of shots a..b-1 alone."""
    n = eng.n_model
    return (*inputs[:n], *(t[a:b] for t in inputs[n:]))


def chunk_against_single_shots(tag, cfg, rs, inputs, shots, eng=ELASTIC):
    """All the shots of `inputs` in one forward with strips and one
    backward (cotangent: the data itself), then each of `shots` alone:
    shots do not interact, so its data, strips, final fields and d_stf must
    have the same bits.  A 32-bit offset into the chunk's strips, state or
    data would move the late shots' values and show here."""
    S = inputs[eng.n_model].shape[0]
    plan = cuda_engine.plan_for(cfg, rs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    data, strips, final = eng.forward(plan, *inputs, save_strips=True)
    d_stf = eng.backward(plan, *inputs, final, strips, data)[-1]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(d_stf).all()), f"{tag} d_stf not finite")
    for k in shots:
        one = _shots(inputs, k, k + 1, eng)
        d1, s1, f1 = eng.forward(plan, *one, save_strips=True)
        check(float(d1[:, eng.arrival_channel].abs().max()) > 1e-6,
              f"{tag} shot {k}: no arrivals at the receivers")
        g1 = eng.backward(plan, *one, f1, s1, d1)[-1]
        check(float(g1.abs().max()) > 0, f"{tag} shot {k}: d_stf is zero")
        same = {"data": torch.equal(d1[0], data[k]),
                "strips": torch.equal(s1[0], strips[k]),
                "final fields": torch.equal(f1[:, 0], final[:, k]),
                "d_stf": torch.equal(g1[0], d_stf[k])}
        check(all(same.values()),
              f"{tag} shot {k} in the chunk differs from the shot alone: "
              f"{same}")
    print(f"{tag} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, {eng.kind}): {S} shots in "
          f"one forward with strips and one backward, {strips.numel()} strip "
          f"floats (2^32 = {2 ** 32}), "
          f"{final.numel() // eng.n_fields * eng.n_state} state floats; data, "
          f"strips, final fields and d_stf of shots {list(shots)} bitwise "
          f"equal to the same shot run alone; peak memory {peak / 1e9:.3f} "
          f"GB")


def phase_invert_large(dev):
    """`invert` at 560x720 padded, nt=2001 (the large-grid command of the
    verify notes), 64 shots; then, on that run's own survey and true model,
    one shot against the plain versions and one chunk of the shots it had
    in flight against its first and last shot run alone."""
    grid = dict(nz=496, nx=656, dz=10.0, dx=10.0, nt=2001, dt=0.001)
    argv = [a for k, v in grid.items() for a in (f"--{k}", f"{v:g}")]
    counts, out, n, chunks = _invert(
        "[14 main path, large grid] invert at 560x720, nt=2001, --niter 2:",
        argv, 64, 2000, 2)
    per_eval = out["seconds"] / n
    cells = 560 * 720 * 2000 * 64
    peak = torch.cuda.max_memory_allocated()
    cfg, rs, inputs = reference_problem(dev, **grid)
    in_flight = out["shot_chunk"] or 64
    assumed = assumed_bytes(cfg, in_flight)
    print(f"[14 main path, large grid] {out['seconds']:.3f} s in L-BFGS-B, "
          f"{per_eval:.3f} s per gradient evaluation, "
          f"{cells / per_eval / 1e9:.2f} GCell/s gradient; shot chunk "
          f"{out['shot_chunk']}; peak memory {peak / 1e9:.3f} GB, "
          f"auto_shot_chunk assumes {assumed / 1e9:.3f} GB for {in_flight} "
          f"shots in flight")
    torch.cuda.empty_cache()
    tag = "[14 large grid vs plain] invert's survey,"
    numbers = hold_against_plain(f"{tag} shot 32 alone", cfg, rs,
                                 _shots(inputs, 32, 33), TOL_LONG)
    torch.cuda.empty_cache()
    chunk_against_single_shots(f"{tag} its first chunk", cfg, rs,
                               _shots(inputs, 0, in_flight),
                               (0, in_flight - 1))
    torch.cuda.empty_cache()
    return counts, numbers


def marmousi_problem(dev, nz, nx, nt, S):
    """The acquisition of examples/marmousi_scale.py with S of its shots:
    (cfg, survey, true Lame planes, initial Lame planes, stf, receiver
    row)."""
    npml = 32
    cfg = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=10.0, dx=10.0,
                    nt=nt, dt=0.001, f0=6.0, npml=npml)
    vp_bg = models.overthrust_vp(nz, nx, v_top=2600.0, v_step=300.0)
    vp_t = vp_bg
    for zf, xf, amp in ((0.22, 0.32, 250.0), (0.38, 0.52, -250.0),
                        (0.30, 0.70, 200.0)):
        vp_t = models.gaussian_anomaly(vp_t, zf * nz, xf * nx,
                                       max(5.0, 0.055 * nz), amp)
    cfg.check_stability(float(vp_t.max()))
    mx = max(4, nx // 50)
    rec_row = int(0.6 * nz)
    survey = Survey(src_z=np.full(S, 2),
                    src_x=np.linspace(mx, nx - mx, S).astype(np.int64),
                    rec_z=np.full(nx - 2 * (mx // 2), rec_row),
                    rec_x=np.arange(mx // 2, nx - mx // 2))
    t = lambda a: torch.as_tensor(pad_model_np(a, npml), device=dev).to(
        torch.float32)

    def lame(vp):
        rho = np.full_like(vp, 2300.0)
        return tuple(a.contiguous() for a in
                     Medium(t(vp), t(vp / np.sqrt(3.0)), t(rho)).to_lame())

    stf = torch.as_tensor(ricker(cfg.f0, nt, cfg.dt), device=dev).to(
        torch.float32).expand(S, nt).contiguous()
    return (cfg, survey, lame(vp_t), lame(models.smooth(vp_bg, 24.0)), stf,
            rec_row)


def phase_marmousi_chunked(dev, nz=750, nx=2000, nt=2001, S=8, chunk=2):
    """One value and gradient of make_cuda_misfit on the survey of
    examples/marmousi_scale.py at its grid (750x2000 physical, 814x2064
    padded) and nt=2001, with 8 of its 24 shots (cut for time), in chunks
    of 2 as there; then its first chunk, on the true model, against the
    plain versions."""
    cfg, survey, true, init, stf, rec_row = marmousi_problem(dev, nz, nx, nt,
                                                             S)
    w = torch.ones(S, device=dev)
    steps = nt - 1
    n_chunks = len(parallel._chunks(S, chunk))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fwd = parallel.make_forward(cfg, survey, use_kernels=True,
                                shot_chunk=chunk, device=dev)
    obs = fwd(*true, stf)
    params = [a.requires_grad_() for a in init]
    loss = parallel.make_cuda_misfit(cfg, survey, shot_chunk=chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = loss(*params, stf, obs, w)
    grads = torch.autograd.grad(val, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"LAUNCHES": 3 * steps * n_chunks * 2,
            "LAUNCHES_STRIPS": 3 * steps * n_chunks,
            "LAUNCHES_BWD": (2 * steps + 1) * n_chunks}
    check_counts("[15 main path, Marmousi scale]", counts, want, plain_calls)
    gmax = [float(g.abs().max()) for g in grads]
    val = val.detach()
    check(np.isfinite(float(val)) and float(val) > 0
          and all(np.isfinite(gmax)) and min(gmax) > 0,
          f"Marmousi-scale misfit {float(val)}, gradient maxima {gmax}")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "Marmousi-scale gradient not finite")
    cells = cfg.nz * cfg.nx * steps * S
    assumed = assumed_bytes(cfg, chunk)
    print(f"[15 main path, Marmousi scale] {cfg.nz}x{cfg.nx}, nt={nt}, {S} "
          f"shots (the example runs 24; cut for time) in {n_chunks} chunks of "
          f"{chunk}, {survey.n_rec} receivers on row {rec_row}: misfit "
          f"{float(val):.6e}, max |gradient| (lam, mu, rho) {gmax}; launches "
          f"= forward 3 x {steps} x {n_chunks} x 2 = {counts['LAUNCHES']} "
          f"(with strips {counts['LAUNCHES_STRIPS']}), backward (2 x {steps} "
          f"+ 1) x {n_chunks} = {counts['LAUNCHES_BWD']}, as expected; plain "
          f"calls {plain_calls}; {seconds:.3f} s per value and gradient, "
          f"{cells / seconds / 1e9:.2f} GCell/s gradient; peak memory "
          f"{peak / 1e9:.3f} GB, auto_shot_chunk assumes {assumed / 1e9:.3f} "
          f"GB for {chunk} shots in flight")
    del obs, grads, params
    torch.cuda.empty_cache()
    n = cfg.npml
    rs = parallel._cuda_plan(cfg, survey)[0].rs
    numbers = hold_against_plain(
        f"[15 large grid vs plain] the Marmousi-scale survey, its first "
        f"chunk of {chunk}", cfg, rs,
        (*true, stf[:chunk], survey.src_z[:chunk] + n,
         survey.src_x[:chunk] + n, survey.src_rxz[:chunk]), TOL_LONG)
    torch.cuda.empty_cache()
    return counts, numbers


def phase_fiber_main_path():
    """examples/das_fwi_torch.py's main with maxiter=3 on the card."""
    cfg = das_fwi_torch.acquisition()[0]
    steps = cfg.nt - 1
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        t0 = time.perf_counter()
        first, last, n = das_fwi_torch.main(d, "cuda", maxiter=3)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, plain_calls = read_counts()
    # the twin data: one forward; an evaluation: a forward with strips and
    # a backward, each with one point launch a step
    want = {"LAUNCHES": 3 * steps * (1 + n), "LAUNCHES_STRIPS": 3 * steps * n,
            "LAUNCHES_FIBER": steps * (1 + n),
            "LAUNCHES_BWD": (3 * steps + 1) * n,
            "LAUNCHES_BWD_FIBER": steps * n}
    check_counts("[16 main path, fiber]", counts, want, plain_calls)
    check(np.isfinite(last) and last < first,
          f"the gauge misfit did not decrease: {first} -> {last}")
    print(f"[16 main path, fiber] das_fwi_torch.main(maxiter=3): gauge "
          f"misfit {first:.6e} -> {last:.6e}; {n} evaluations; launches = "
          f"forward 3 x {steps} x (1 + {n}) = {counts['LAUNCHES']} (with "
          f"strips {counts['LAUNCHES_STRIPS']}, record_points "
          f"{counts['LAUNCHES_FIBER']}), backward (3 x {steps} + 1) x {n} = "
          f"{counts['LAUNCHES_BWD']} (inject_points "
          f"{counts['LAUNCHES_BWD_FIBER']}), as expected; plain calls "
          f"{plain_calls}; {seconds:.3f} s in all")
    return counts


def _acoustic_forward_pair(label, cfg, rs, args, tol):
    """acoustic_forward without strips and with them: the launch counters,
    the same data either way, and both against the plain version with
    strips.  Returns (the kernel's (data, strips, final), the errors)."""
    steps = cfg.nt - 1
    plan = cuda_engine.plan_for(cfg, rs)
    reset_counts()
    out = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args,
                                                   save_strips=True)
    data = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args)
    counts, _ = read_counts()
    check(counts_are(counts, {"LAUNCHES_AC": 6 * steps,
                              "LAUNCHES_AC_STRIPS": 3 * steps})
          and 3 * steps == cuda_acoustic.launches_forward_acoustic(cfg),
          f"{label}: forward launch counters {counts}")
    check(torch.equal(data, out[0]), f"{label}: strip saving changed the data")
    ref = cuda_acoustic.forward_plain_acoustic_strips(cfg, rs, *args)
    d, s, f = strip_errors(out, ref)
    check(max(d) < tol and max(s + f) < TOL,
          f"{label}: kernel vs plain {d} {s} {f}")
    peaks = [float(ref[0][:, c].abs().max()) for c in range(3)]
    check(min(peaks) > 1e-3, f"{label}: no arrivals at the receivers {peaks}")
    return out, (d, s, f)


def _acoustic_image_pair(label, cfg, rs, args, final, strips, residual,
                         timed=False):
    """The imaging variant of acoustic_backward against
    rtm_image_time_plain: image and illumination of every shot (GRAD_TOL of
    each one's max), their sums over shots, a second run bitwise, the
    launch counters.  With timed, returns the numbers of the kernels line
    (the plain version's time includes its forward with strips)."""
    lam, rho, stf, sz, sx = args
    plan = cuda_engine.plan_for(cfg, rs)
    vp = torch.sqrt(lam / rho).contiguous()
    image = lambda **kw: cuda_acoustic.image_cuda_acoustic_plan(
        plan, vp, rho, stf, sz, sx, final, strips, residual, **kw)
    reset_counts()
    img, ill = image()
    counts, _ = read_counts()
    n = cuda_acoustic.launches_backward_acoustic(cfg, rs)
    check(counts_are(counts, {"LAUNCHES_AC_BWD": n, "LAUNCHES_AC_IMG": n}),
          f"{label}: imaging launch counters {counts}")
    (img_p, ill_p), plain_ms = _timed(
        lambda: cuda_acoustic.rtm_image_time_plain(cfg, rs, vp, rho, stf, sz,
                                                   sx, residual))
    check(float(img_p.abs().max()) > 0 and float(ill_p.max()) > 0,
          f"{label}: the plain image is zero")
    img_s, ill_s = image(sum_shots=True)
    err = [rel_err(img, img_p), rel_err(ill, ill_p),
           rel_err(img_s, img_p.sum(0)), rel_err(ill_s, ill_p.sum(0))]
    check(all(np.isfinite(err)) and max(err) < GRAD_TOL,
          f"{label}: image, illumination and their shot sums vs plain {err}")
    again = image()
    check(torch.equal(again[0], img) and torch.equal(again[1], ill),
          f"{label}: a second imaging run gave other bits")
    print(f"{label} imaging variant vs plain: max rel err (image, "
          f"illumination, their sums over shots) {err} < {GRAD_TOL}; a "
          f"second run bitwise equal; launches {n}")
    if not timed:
        return None
    abs_err = max(float((a - b).abs().max())
                  for a, b in ((img, img_p), (ill, ill_p)))
    n_bytes = nbytes(vp, rho, stf, final, strips, residual, img, ill)
    del img_p, ill_p, again
    ms = cuda_ms(image, 3)
    b_ms, b_by = bound(cfg, stf.shape[0], AC_IMG_OPS_PER_CELL_STEP, n_bytes)
    print(f"{label} imaging variant, CUDA events: kernel {ms:.3f} ms (mean "
          f"of 3), plain {plain_ms:.3f} ms (the comparison's run, with its "
          f"forward); bound {b_ms:.3f} ms ({b_by}, {n_bytes / 1e9:.3f} GB)")
    return dict(max_abs_err=abs_err, max_rel_err=max(err), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def _acoustic_case(label, cfg, rs, args):
    """A small acoustic case: forward, strips, backward (cotangent: the L2
    residual against the model with lam raised by 3%), a second backward
    bitwise, the adjoint dot product, the reconstruction, the image."""
    plan = cuda_engine.plan_for(cfg, rs)
    (syn, strips, final), (d, s, f) = _acoustic_forward_pair(label, cfg, rs,
                                                             args, TOL)
    cot = ac_perturbed_cotangent(cfg, rs, args, syn)
    check(float(cot.abs().max()) > 1e-3 * float(syn.abs().max()),
          f"{label}: the cotangent is round-off")
    res = (*args, final, strips, cot)
    g = cuda_acoustic.backward_cuda_acoustic_plan(plan, *res)
    g_ref = cuda_acoustic.backward_plain_acoustic(cfg, rs, *res)
    check(all(float(a.abs().max()) > 0 for a in g_ref),
          f"{label}: a plain gradient is zero")
    err = grad_errors(g, g_ref, cfg, AC_INTERIOR)
    check(max(err) < GRAD_TOL, f"{label}: backward vs plain {err}")
    reset_counts()
    again = cuda_acoustic.backward_cuda_acoustic_plan(plan, *res)
    counts, _ = read_counts()
    n = cuda_acoustic.launches_backward_acoustic(cfg, rs)
    check(counts_are(counts, {"LAUNCHES_AC_BWD": n}),
          f"{label}: backward launch counters {counts}")
    check(all(torch.equal(a, b) for a, b in zip(g, again)),
          f"{label}: a second backward run gave other bits")
    _, _, gap = adjoint_gap(cfg, rs, args)
    check(gap <= DOT_TOL, f"{label}: adjoint gap {gap} > {DOT_TOL}")
    kern = reconstruction_residual(
        cfg, cuda_acoustic.reconstruct_cuda_acoustic_plan(
            plan, *args, final, strips), syn)
    plain = reconstruction_residual(
        cfg, cuda_acoustic.reconstruct_plain_acoustic(
            cfg, rs, *args, final, strips), syn)
    check(np.isfinite(kern) and kern <= RECON_RATIO * plain,
          f"{label}: reconstruction residual {kern} > {RECON_RATIO} x {plain}")
    print(f"[17 acoustic vs plain] {label} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, "
          f"{type(rs).__name__}, {rs.n_rec} receivers): max rel err data per "
          f"channel {d}, strips {max(s)}, final fields {max(f)} < {TOL}; "
          f"(d_lam, d_rho, d_stf) {err} < {GRAD_TOL} on the tight interior "
          f"less {AC_INTERIOR}; adjoint gap {gap:.3e} <= {DOT_TOL}; a second "
          f"backward bitwise equal; reconstruction residual / peak |pr| "
          f"kernel {kern:.6e}, plain f32 {plain:.6e}; launches a forward "
          f"3 x {cfg.nt - 1}, a backward {n}")
    _acoustic_image_pair(f"[17 acoustic vs plain] {label}", cfg, rs, args,
                         final, strips, -cot)


def phase_acoustic_vs_plain(dev):
    """K5, K5 with strips, K6 and its imaging variant against their plain
    versions: AC_CASES, the reference shape (nt=301, 2 shots) and the
    reference workload, where they are timed: returns that case's (forward,
    forward with strips, backward, imaging) numbers."""
    for name in AC_CASES:
        _acoustic_case(name, *ac_problem(name, device=dev))
    _acoustic_case("reference shape nt=301",
                   *ac_row_problem(101, 201, 32, 301, 2, 40, device=dev))

    cfg, rs, args = acoustic_reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    tag = "[17 acoustic vs plain] reference workload"
    fwd_strips, bwd = hold_against_plain(tag, cfg, rs, args, TOL_LONG,
                                         silent_samples=0, eng=ACOUSTIC)
    # K5 without strips: its data equal those of the forward with strips
    # (held against plain just above) bit for bit, so they share its errors
    syn, strips, final = cuda_acoustic.forward_cuda_acoustic_plan(
        plan, *args, save_strips=True)
    out = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args)
    check(torch.equal(out, syn), f"{tag}: strip saving changed the data")
    ref, plain_ms = _timed(lambda: cuda_acoustic.forward_plain_acoustic(
        cfg, rs, *args))
    d = [rel_err(out[:, c], ref[:, c]) for c in range(3)]
    check(max(d) < TOL_LONG, f"{tag}: forward vs plain {d} >= {TOL_LONG}")
    abs_err = float((out - ref).abs().max())
    n_bytes = nbytes(*args[:3], out)
    del ref
    ms = cuda_ms(lambda: cuda_acoustic.forward_cuda_acoustic_plan(plan, *args),
                 5)
    b_ms, b_by = bound(cfg, 19, AC_FWD_OPS_PER_CELL_STEP, n_bytes)
    print(f"{tag} (19 shots): forward without strips vs plain: max rel err "
          f"per channel {d} < {TOL_LONG}; CUDA events: kernel {ms:.3f} ms "
          f"(mean of 5), plain {plain_ms:.3f} ms (the comparison's run); "
          f"bound {b_ms:.3f} ms ({b_by}, {n_bytes / 1e9:.3f} GB)")
    fwd = dict(max_abs_err=abs_err, max_rel_err=max(d), ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    residual = -ac_perturbed_cotangent(cfg, rs, args, syn)
    img = _acoustic_image_pair(tag, cfg, rs, args, final, strips, residual,
                               timed=True)
    _, _, gap = adjoint_gap(cfg, rs, args)
    check(gap <= DOT_TOL, f"{tag}: adjoint gap {gap} > {DOT_TOL}")
    print(f"{tag}: adjoint gap {gap:.3e} <= {DOT_TOL}")
    return fwd, fwd_strips, bwd, img


# The shapes of the JAX package's streamed acoustic pair (K7/K8): one shot
# on each large grid with phase 13's receiver rows.
AC_LARGE_CASES = ("560x720 row", "814x2064 row")


def ac_large_problem(name, dev, shots=1):
    """(cfg, rs, acoustic inputs) of a LARGE_CASES row case, the one shot
    repeated `shots` times along x."""
    nz, nx, nt, kind = LARGE_CASES[name]
    cfg, rs, inputs = large_problem(nz, nx, nt, kind, dev)
    lam, rho, stf, sz, sx = acoustic_args(inputs)
    if shots > 1:
        stf = stf.expand(shots, nt).contiguous()
        sz = np.full(shots, sz[0])
        sx = np.linspace(60, nx - 60, shots).astype(np.int64)
    return cfg, rs, (lam, rho, stf, sz, sx)


def phase_acoustic_large(dev):
    """K5 with strips and K6 at the streamed pair's shapes against the plain
    versions, one shot each (returns their numbers by case), and a chunk
    of shots at 560x720 whose strip floats pass 2^32 against its first and
    last shot run alone, bit for bit."""
    numbers = {}
    for name in AC_LARGE_CASES:
        numbers[name] = hold_against_plain(
            f"[18 acoustic, streamed shapes vs plain] {name}",
            *ac_large_problem(name, dev), TOL_LONG, eng=ACOUSTIC)
        torch.cuda.empty_cache()
    cfg, rs, _ = ac_large_problem("560x720 row", dev)
    per_shot = (cfg.nt - 1) * 3 * 2 * cfg.n_bnd_layers * (cfg.nz + cfg.nx)
    shots = 2 ** 32 // per_shot + 1
    cfg, rs, args = ac_large_problem("560x720 row", dev, shots)
    chunk_against_single_shots(
        "[18 acoustic, streamed shapes] a chunk at 560x720", cfg, rs, args,
        (0, shots - 1), eng=ACOUSTIC)
    torch.cuda.empty_cache()
    return numbers


def _acoustic_gradient_fn(cfg, rs, args):
    """One acoustic gradient evaluation as the JAX package's bench makes it
    (bench.py sec_acoustic): loss 0.5 sum(d^2), gradients of lam and rho
    through propagate_cuda_acoustic_plan."""
    lam, rho, stf, sz, sx = args
    plan = cuda_engine.plan_for(cfg, rs)

    def gradient():
        params = [a.clone().requires_grad_() for a in (lam, rho)]
        d = cuda_acoustic.propagate_cuda_acoustic_plan(plan, *params, stf,
                                                       sz, sx)
        return torch.autograd.grad(0.5 * (d * d).sum(), params)

    return gradient


def _counted_gradient(label, cfg, rs, args, reps):
    """One gradient of `_acoustic_gradient_fn` with the counts set to 0 just
    before and read just after (exact, no plain call), finite and nonzero;
    then its CUDA-event time.  Returns (counts, ms)."""
    gradient = _acoustic_gradient_fn(cfg, rs, args)
    steps = cfg.nt - 1
    reset_counts()
    g = gradient()
    torch.cuda.synchronize()
    counts, plain_calls = read_counts()
    check_counts(label, counts, {
        "LAUNCHES_AC": 3 * steps, "LAUNCHES_AC_STRIPS": 3 * steps,
        "LAUNCHES_AC_BWD": 2 * steps + 1}, plain_calls)
    gmax = [float(a.abs().max()) for a in g]
    check(all(bool(torch.isfinite(a).all()) for a in g) and min(gmax) > 0,
          f"{label}: gradient maxima {gmax}")
    del g
    ms = cuda_ms(gradient, reps, warm=False)
    S = args[2].shape[0]
    cells = cfg.nz * cfg.nx * steps * S
    print(f"{label} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, {S} shot(s)): max "
          f"|gradient| (lam, rho) {gmax}; launches forward with strips 3 x "
          f"{steps} = {counts['LAUNCHES_AC']}, backward 2 x {steps} + 1 = "
          f"{counts['LAUNCHES_AC_BWD']}, as expected; plain calls 0; "
          f"{ms:.3f} ms a gradient (CUDA events, mean of {reps}), "
          f"{cells / ms / 1e6:.2f} GCell/s")
    return counts, ms


def _rtm(label, argv, want, z_refl, tol_rows=15):
    """`rtm` through cli.main with the counts set to 0 just before and read
    just after: exact launch counts, no plain call, the .npz keys finite,
    the muted image's peak within tol_rows rows (one wavelength at 10 Hz)
    of the reflector."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "img.npz")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, illum, peak = cli.main(["rtm", *argv, "--out", out])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        npz = np.load(out)
        keys = sorted(npz.files)
        check(keys == sorted(["image", "image_muted", "illumination",
                              "image_compensated", "vp_true",
                              "vp_background", "z_reflector"]),
              f"{label}: .npz keys {keys}")
        check(all(np.isfinite(npz[k]).all() for k in keys),
              f"{label}: a .npz array is not finite")
        check(np.array_equal(npz["image"], img) and int(npz["z_reflector"])
              == z_refl, f"{label}: the .npz does not hold the image")
        shape = npz["image"].shape
    check_counts(label, counts, want, plain_calls)
    check(float(np.abs(img).max()) > 0 and float(illum.max()) > 0,
          f"{label}: the image or the illumination is zero")
    check(abs(peak - z_refl) <= tol_rows,
          f"{label}: muted-image peak at z={peak}, reflector at z={z_refl}")
    print(f"{label} image {shape} finite, muted-image peak at z={peak}, "
          f"reflector at z={z_refl} (within {tol_rows} rows); launches "
          f"{ {k: v for k, v in counts.items() if v} }, as expected; plain "
          f"calls 0; {seconds:.3f} s in all")
    return counts


def phase_acoustic_main_paths(dev, streamed):
    """The acoustic and imaging main paths, each with exact launch counts
    and no plain call.  `streamed`: phase 18's numbers by case.  Returns
    what the kernels line needs."""
    r = {}
    # (a) forward --physics acoustic at the CLI defaults, the files read back
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        data = cli.main(["forward", "--physics", "acoustic", "--data-dir", d])
        counts, plain_calls = read_counts()
        check_counts("[19a main path] forward --physics acoustic", counts,
                     {"LAUNCHES_AC": 3 * 1500}, plain_calls)
        out = data.cpu().numpy()
        check(data.device.type == "cuda" and out.shape == (19, 3, 181, 1501)
              and np.isfinite(out).all(), f"acoustic data {out.shape}")
        peaks = [float(np.abs(out[:, c]).max()) for c in range(3)]
        check(min(peaks) > 0, f"an acoustic channel is zero: {peaks}")
        n_files = len([f for f in os.listdir(d) if f.startswith("Shot_")])
        back = sio.read_shots(d, 19, 181, 1501)
        check(n_files == 76 and np.array_equal(back[:, :3], out)
              and not back[:, 3].any(), "acoustic Shot files differ from the "
              "data, or ett is not zero")
    r["forward"] = counts
    print(f"[19a main path] forward --physics acoustic: "
          f"{counts['LAUNCHES_AC']} kernel launches, data {out.shape} finite, "
          f"max |pr, vx, vz| {peaks}, 76 Shot files read back equal, ett 0")

    # (b) the same at 560x720 padded, 64 shots, nt=2001: the path that the
    # streamed forward carries on the TPU; then held against plain there
    grid = dict(nz=496, nx=656, dz=10.0, dx=10.0, nt=2001, dt=0.001)
    argv = [a for k, v in grid.items() for a in (f"--{k}", f"{v:g}")]
    reset_counts()
    data = cli.main(["forward", "--physics", "acoustic", *argv])
    torch.cuda.synchronize()
    counts, plain_calls = read_counts()
    check_counts("[19b main path] forward --physics acoustic at 560x720",
                 counts, {"LAUNCHES_AC": 3 * 2000}, plain_calls)
    check(tuple(data.shape) == (64, 3, 636, 2001)
          and bool(torch.isfinite(data).all()), f"data {tuple(data.shape)}")
    cfg, rs, args = acoustic_reference_problem(dev, **grid)
    plan = cuda_engine.plan_for(cfg, rs)
    ref, plain_ms = _timed(lambda: cuda_acoustic.forward_plain_acoustic(
        cfg, rs, *args))
    d = [rel_err(data[:, c], ref[:, c]) for c in range(3)]
    check(min(float(ref[:, c].abs().max()) for c in range(3)) > 1e-6
          and max(d) < TOL_LONG, f"[19b] forward vs plain {d}")
    abs_err = float((data - ref).abs().max())
    n_bytes = nbytes(*args[:3], data)
    del ref, data
    ms = cuda_ms(lambda: cuda_acoustic.forward_cuda_acoustic_plan(plan, *args),
                 2)
    b_ms, b_by = bound(cfg, 64, AC_FWD_OPS_PER_CELL_STEP, n_bytes)
    cells = cfg.nz * cfg.nx * 2000 * 64
    print(f"[19b main path] forward --physics acoustic at {cfg.nz}x{cfg.nx}, "
          f"nt=2001, 64 shots: {counts['LAUNCHES_AC']} kernel launches; vs "
          f"plain on the same inputs: max rel err per channel {d} < "
          f"{TOL_LONG}; CUDA events: kernel {ms:.3f} ms (mean of 2, "
          f"{cells / ms / 1e6:.2f} GCell/s), plain {plain_ms:.3f} ms (the "
          f"comparison's run); bound {b_ms:.3f} ms ({b_by}, "
          f"{n_bytes / 1e9:.3f} GB)")
    r["forward_large"] = (counts, dict(
        max_abs_err=abs_err, max_rel_err=max(d), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by))
    torch.cuda.empty_cache()

    # (c) rtm at its defaults: acoustic, 19 shots in one chunk
    r["rtm"] = _rtm("[19c main path] rtm (acoustic):", [], {
        "LAUNCHES_AC": 3 * 3 * 1500, "LAUNCHES_AC_STRIPS": 3 * 1500,
        "LAUNCHES_AC_BWD": 2 * 1500 + 1, "LAUNCHES_AC_IMG": 2 * 1500 + 1}, 67)

    # (d) the bench's acoustic gradient at the reference workload
    bench = acoustic_reference_problem(dev, vp=2000.0)
    r["gradient"] = _counted_gradient(
        "[19d main path] the bench's acoustic gradient (lam = rho 2000^2)",
        *bench, 3)

    # (e) rtm --physics elastic: K1, K1 with strips and K2 with cotangents
    # on pr, vx and vz
    r["rtm_elastic"] = _rtm(
        "[19e main path] rtm --physics elastic --nt 1001:",
        ["--physics", "elastic", "--nt", "1001"], {
            "LAUNCHES": 2 * 3 * 1000, "LAUNCHES_STRIPS": 3 * 1000,
            "LAUNCHES_BWD": 2 * 1000 + 1}, 67)

    # (f) the same differentiable propagation at the streamed pair's shapes
    # (propagate_pallas_acoustic_auto's streamed branch on the TPU)
    for name in AC_LARGE_CASES:
        counts, _ = _counted_gradient(
            f"[19f main path] the acoustic gradient at {name}",
            *ac_large_problem(name, dev), 2)
        r[name] = (counts, streamed[name])
        torch.cuda.empty_cache()
    return r


def _profile(label, fn):
    """Device-time breakdown of fn() under torch.profiler: time per kernel,
    the device window from the first device event to the last, and its
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up outside the trace
    torch.cuda.synchronize()
    # device activity only: with the CPU's events beside them, building the
    # event list of a gradient's trace (19000 events) can take over a minute
    # on the host, and the device spans come out the same
    # (examples/profiler_cost_torch.py)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:  # a measurement, not a gate: the phases above checked
        print(f"[6 profile] {label}: torch.profiler recorded no device "
              "events: breakdown not measured")
        return
    per_name = {}
    busy, reach = 0.0, spans[0][0]    # union of the device intervals, us
    for t0, t1, name in spans:
        n, us = per_name.get(name, (0, 0.0))
        per_name[name] = (n + 1, us + t1 - t0)
        busy += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    window = reach - spans[0][0]
    rest = [0, 0, 0.0]      # kernels under 0.1% of busy: names, launches, us
    for name, (n, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        if us < 1e-3 * busy:
            rest = [rest[0] + 1, rest[1] + n, rest[2] + us]
            continue
        print(f"[6 profile] {label}: {name[:60]}: {n} launches, "
              f"{us / 1e3:.3f} ms, {us / n:.3f} us each, "
              f"{100 * us / busy:.2f}% of busy")
    print(f"[6 profile] {label}: the rest ({rest[0]} kernels under 0.1% of "
          f"busy each): {rest[1]} launches, {rest[2] / 1e3:.3f} ms, "
          f"{100 * rest[2] / busy:.2f}% of busy")
    print(f"[6 profile] {label}: device window {window / 1e3:.3f} ms, busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / window:.4f}")


def _gradient_fn(cfg, rs, inputs, obs=None):
    """One gradient evaluation as `invert` makes it: forward with strips,
    L2 misfit on ett against obs (the data of lam raised by 3% when not
    given), backward."""
    lam, mu, rho, stf, sz, sx, rxz = inputs
    plan = cuda_engine.plan_for(cfg, rs)
    if obs is None:
        obs = cuda_engine.forward_cuda_plan(plan, (lam * 1.03).contiguous(),
                                            mu, rho, stf, sz, sx, rxz)

    def gradient():
        params = [a.clone().requires_grad_() for a in (lam, mu, rho, stf)]
        syn = cuda_engine.propagate_cuda_plan(plan, *params, sz, sx, rxz)
        return torch.autograd.grad(l2_misfit(obs, syn), params)

    return gradient


def phase_profile(dev):
    """One reference forward_cuda call, one reference gradient evaluation,
    one reference acoustic gradient evaluation, and one one-shot gradient
    evaluation on each large grid."""
    cfg, rs, inputs = reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    _profile("one reference forward_cuda_plan",
             lambda: cuda_engine.forward_cuda_plan(plan, *inputs))
    _profile("one reference gradient evaluation",
             _gradient_fn(cfg, rs, inputs))
    _profile("one reference acoustic gradient evaluation (lam = rho 2000^2)",
             _acoustic_gradient_fn(*acoustic_reference_problem(dev,
                                                               vp=2000.0)))
    for name in ("560x720 row", "814x2064 row"):
        nz, nx, nt, kind = LARGE_CASES[name]
        cfg, rs, inputs = large_problem(nz, nx, nt, kind, dev)
        _profile(f"one gradient evaluation, {name}, nt={nt}, 1 shot",
                 _gradient_fn(cfg, rs, inputs))
        torch.cuda.empty_cache()


def kernel_record(results):
    """The JSON record of every kernel.  `launches` are the counts of the
    kernel's main path, read just after it ran from counts set to 0 just
    before; every other number was measured in this run at that main path's
    shapes: the reference workload (K1, K1-strips, K2; K5, K5-strips, K6 and
    its imaging variant), the acquisition of examples/das_fwi_torch.py
    (K1-fiber), one shot of `invert` at 560x720, nt=2001 and one chunk of 2
    shots at 814x2064, nt=2001 (K3, K4), `forward --physics acoustic` at
    560x720, nt=2001, 64 shots and the one-shot acoustic gradients at
    560x720, nt=1001 and 814x2064, nt=601 (K7, K8).
    max_abs_err is in the outputs' own units, over outputs of very
    different magnitudes (the four gradients of a backward); max_rel_err is
    relative to each output's max and is what the phases check."""
    r = results
    cfg, _, inputs = r["reference"]
    k1_bytes = nbytes(*inputs[:4]) + 19 * 4 * 181 * cfg.nt * 4
    k1_bound, k1_by = bound(cfg, 19, FWD_OPS_PER_CELL_STEP, k1_bytes)
    abs_err, kernel_ms, plain_ms, rel_err = r[3]
    fwd_src = "sep2023_tpu_torch/csrc/elastic_fwd.cu"
    bwd_src = "sep2023_tpu_torch/csrc/elastic_bwd.cu"
    fused = "sep2023_tpu/ops/pallas_engine.py:"
    stream = "sep2023_tpu/ops/pallas_stream.py:"

    def entry(name, source, replaces, launches, numbers):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, **numbers,
                "library_ms": None}

    kernels = [
        entry("elastic_forward (stress, velocity, record)", fwd_src,
              fused + "875", r[4],
              dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=kernel_ms,
                   plain_ms=plain_ms, bound_ms=k1_bound, bound_by=k1_by)),
        entry("elastic_forward with boundary strips (stress, velocity, "
              "record)", fwd_src, fused + "875", r[11]["LAUNCHES_STRIPS"],
              r[7]),
        entry("elastic_backward (velocity, stress, shot sum)", bwd_src,
              fused + "1186", r[11]["LAUNCHES_BWD"], r[8]),
        entry("elastic_forward with point receivers and boundary strips "
              "(stress, velocity, record_points), the acquisition of "
              "examples/das_fwi_torch.py", fwd_src, fused + "875",
              r[16]["LAUNCHES_STRIPS"], r[12][0]),
        entry("elastic_backward with point receivers (inject_points, "
              "velocity, stress, shot sum), the acquisition of "
              "examples/das_fwi_torch.py", bwd_src, fused + "1186",
              r[16]["LAUNCHES_BWD"], r[12][1]),
    ]
    for shape, (counts, (fwd, bwd)) in (
            ("560x720, nt=2001, 1 shot", r[14]),
            ("814x2064, nt=2001, 2 shots", r[15])):
        kernels.append(entry(
            f"elastic_forward with boundary strips at {shape}, the streamed "
            "forward's shapes", fwd_src, stream + "1243",
            counts["LAUNCHES_STRIPS"], fwd))
        kernels.append(entry(
            f"elastic_backward at {shape}, the streamed backward's shapes",
            bwd_src, stream + "1794", counts["LAUNCHES_BWD"], bwd))

    ac_fwd_src = "sep2023_tpu_torch/csrc/acoustic_fwd.cu"
    ac_bwd_src = "sep2023_tpu_torch/csrc/acoustic_bwd.cu"
    k5, k5_strips, k6, k6_img = r[17]
    ac = r[19]
    kernels += [
        entry("acoustic_forward (pressure, velocity, record)", ac_fwd_src,
              fused + "1512", ac["forward"]["LAUNCHES_AC"], k5),
        entry("acoustic_forward with boundary strips (pressure, velocity, "
              "record)", ac_fwd_src, fused + "1512",
              ac["gradient"][0]["LAUNCHES_AC_STRIPS"], k5_strips),
        entry("acoustic_backward (velocity, pressure, shot sum)", ac_bwd_src,
              fused + "1746", ac["gradient"][0]["LAUNCHES_AC_BWD"], k6),
        entry("acoustic_backward, imaging variant (velocity, pressure with "
              "the image and illumination accumulators, shot sum): "
              "acoustic.rtm_image_time's route on the card", ac_bwd_src,
              "sep2023_tpu/acoustic.py:224", ac["rtm"]["LAUNCHES_AC_IMG"],
              k6_img),
        entry("acoustic_forward at 560x720, nt=2001, 64 shots, the streamed "
              "acoustic forward's shapes", ac_fwd_src, stream + "2167",
              ac["forward_large"][0]["LAUNCHES_AC"], ac["forward_large"][1]),
    ]
    for name, shape in (("560x720 row", "560x720, nt=1001, 1 shot"),
                        ("814x2064 row", "814x2064, nt=601, 1 shot")):
        counts, (fwd, bwd) = ac[name]
        kernels.append(entry(
            f"acoustic_forward with boundary strips at {shape}, the streamed "
            "acoustic forward's shapes", ac_fwd_src, stream + "2167",
            counts["LAUNCHES_AC_STRIPS"], fwd))
        kernels.append(entry(
            f"acoustic_backward at {shape}, the streamed acoustic "
            "backward's shapes", ac_bwd_src, stream + "2493",
            counts["LAUNCHES_AC_BWD"], bwd))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on its main path")
    return {"kernels": kernels}


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    results = {"reference": reference_problem(dev)}
    phases = [
        (3, lambda: phase_kernel_vs_plain(dev)),
        (4, lambda: phase_main_path(results[3][2])),
        (5, lambda: phase_api(dev)),
        (7, lambda: phase_strips_vs_plain(dev)),
        (8, lambda: phase_backward_vs_plain(dev)),
        (9, lambda: phase_adjoint_dot(dev)),
        (10, lambda: phase_reconstruction(dev)),
        (11, phase_invert_main_path),
        (12, lambda: phase_fiber_vs_plain(dev)),
        (13, lambda: phase_large_vs_plain(dev)),
        (14, lambda: phase_invert_large(dev)),
        (15, lambda: phase_marmousi_chunked(dev)),
        (16, phase_fiber_main_path),
        (17, lambda: phase_acoustic_vs_plain(dev)),
        (18, lambda: phase_acoustic_large(dev)),
        (19, lambda: phase_acoustic_main_paths(dev, results[18])),
        (6, lambda: phase_profile(dev)),
    ]
    for number, run in phases:
        t0 = time.perf_counter()
        results[number] = run()
        torch.cuda.synchronize()
        print(f"[{number}] phase took {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_start:.1f} s since the start)",
              flush=True)
    print(json.dumps(kernel_record(results)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
