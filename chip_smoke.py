"""Smoke test of sep2023_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from csrc/, holds each against its plain PyTorch version on the card
(the forward, the forward with boundary strips, the boundary-saving
adjoint, its reconstruction, the adjoint dot product; receiver rows and
point receivers; the reference workload and the large grids 560x720 and
814x2064), drives the main paths through them (`forward` and `invert` at
the reference workload, `invert` at 560x720, a chunked Marmousi-scale
gradient at 814x2064, the curved-fiber inversion of
examples/das_fwi_torch.py), checks the ElasticPropagator API, and prints
the device-time breakdown of a reference forward, a reference gradient
and two large-grid gradients (torch.profiler).  The two large main paths
are also held against the plain versions at their own shapes (nt=2001, the
main path's survey), and the 54-shot chunk of the 560x720 one, whose strip
offsets pass 2^32, against the same shots run alone, bit for bit.

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

import numpy as np
import torch

from sep2023_tpu_torch import api, cli, das, models, parallel
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import _build, cuda_engine
from sep2023_tpu_torch.ops import signal as sg
from sep2023_tpu_torch.ops.misfit import l2_misfit
from sep2023_tpu_torch.testing import (DOT_TOL, FIBER_CASES, GRAD_TOL,
                                       RECON_RATIO, ROW_CASES, adjoint_gap,
                                       fiber_problem, grad_errors,
                                       perturbed_cotangent,
                                       reconstruction_residual, row_problem,
                                       strip_errors)

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
#     reconstruction 18, elastic cotangents and gradients 33, 20): 215.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
FWD_OPS_PER_CELL_STEP = 102
BWD_OPS_PER_CELL_STEP = 215


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


COUNTERS = ("LAUNCHES", "LAUNCHES_STRIPS", "LAUNCHES_FIBER", "LAUNCHES_BWD",
            "LAUNCHES_BWD_FIBER")


def reset_counts():
    """Set every launch counter and every plain-call count to 0."""
    for k in COUNTERS:
        setattr(cuda_engine, k, 0)
    for k in cuda_engine.PLAIN_CALLS:
        cuda_engine.PLAIN_CALLS[k] = 0


def read_counts():
    """(launch counters by name, plain calls by name) since reset_counts."""
    return ({k: getattr(cuda_engine, k) for k in COUNTERS},
            dict(cuda_engine.PLAIN_CALLS))


def check_counts(label, got, want, plain_calls):
    """The launch counters equal `want` (a name missing there must be 0)
    and no plain version ran."""
    want = {k: want.get(k, 0) for k in COUNTERS}
    check(got == want, f"{label}: launches {got}, expected {want}")
    check(sum(plain_calls.values()) == 0,
          f"{label} called the plain versions: {plain_calls}")


def reference_problem(dev, nz=101, nx=201, **grid):
    """The inputs `forward` and `invert` build for their true model, at
    their defaults (101x201 + npml 32, nt=1501, 19 shots, 181 receivers at
    z=95) or at another grid of cli.benchmark_problem."""
    cfg, survey, geoms, stf = cli.benchmark_problem(nz=nz, nx=nx, **grid,
                                                    device=dev)
    stf = (stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=dev)
           ).contiguous()
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    t = lambda a: torch.as_tensor(pad_model_np(a, cfg.npml), device=dev).to(
        torch.float32)
    lam, mu, rho = Medium(t(vp), t(vs), t(rho)).to_lame()
    rs = cuda_engine.check_row_survey(survey.rec_z + cfg.npml,
                                      survey.rec_x + cfg.npml)
    return cfg, rs, (lam, mu, rho, stf, geoms.src_z, geoms.src_x, geoms.rxz)


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
    check(counts == {"LAUNCHES": 6 * steps, "LAUNCHES_STRIPS": 3 * steps,
                     "LAUNCHES_FIBER": 2 * steps, "LAUNCHES_BWD": 0,
                     "LAUNCHES_BWD_FIBER": 0},
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


def hold_against_plain(tag, cfg, rs, inputs, tol, silent_samples=20):
    """All the shots of `inputs` through K1-strips and K2 (with point
    receivers: K1-fiber) against their plain versions: data, strips, final
    fields (`tol`), gradients (GRAD_TOL), a second backward bitwise, the
    reconstruction residual, CUDA-event times, bounds and peak memory.  The
    cotangent is the data itself (the loss 0.5 sum(syn^2) of bench.py's
    large-grid cells).  The kernels' times are means of 3 runs; each plain
    version runs once, for the comparison, and that run is the one timed.
    Returns the (forward, backward) numbers of the kernels line."""
    S = inputs[3].shape[0]
    plan = cuda_engine.plan_for(cfg, rs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = cuda_engine.forward_cuda_plan(plan, *inputs, save_strips=True)
    data, strips, final = out
    d_data = data.clone()
    res = (*inputs, final, strips, d_data)
    g = cuda_engine.backward_cuda_plan(plan, *res)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assumed = S * (parallel.strip_bytes_per_shot(cfg)
                   + parallel.state_bytes_per_shot(cfg))
    ett = data[:, 3].abs()
    check(float(ett.max()) > 1e-6, f"{tag} no arrivals at the receivers")
    if silent_samples:  # and the receivers are far enough to see it arrive
        check(float(ett[..., :silent_samples].max())
              < 1e-6 * float(ett.max()), f"{tag} arrivals from sample 0")

    ref, fwd_plain = _timed(lambda: cuda_engine.forward_plain_strips(
        cfg, rs, *inputs))
    d, s, f = strip_errors(out, ref)
    check(max(d + s + f) < tol, f"{tag} forward vs plain {d} {s} {f}")
    fwd_abs = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    del ref
    g_ref, bwd_plain = _timed(lambda: cuda_engine.backward_plain(
        cfg, rs, *res))
    err = grad_errors(g, g_ref, cfg)
    check(all(np.isfinite(err)) and max(err) < GRAD_TOL,
          f"{tag} backward vs plain {err}")
    check(all(float(a.abs().max()) > 0 for a in g_ref), f"{tag} a plain "
          "gradient is zero")
    bwd_abs = max(float((a - b).abs().max()) for a, b in zip(g, g_ref))
    again = cuda_engine.backward_cuda_plan(plan, *res)
    check(all(torch.equal(a, b) for a, b in zip(g, again)),
          f"{tag} a second backward run gave other bits")
    fwd_bytes = nbytes(*inputs[:4], *out)
    bwd_bytes = nbytes(*inputs[:4], final, strips, d_data, *g)
    del again, g_ref

    kern = reconstruction_residual(cfg, cuda_engine.reconstruct_cuda_plan(
        plan, *inputs, final, strips), data)
    plain = reconstruction_residual(cfg, cuda_engine.reconstruct_plain(
        cfg, rs, *inputs, final, strips), data)
    check(np.isfinite(kern) and kern <= RECON_RATIO * plain,
          f"{tag} reconstruction residual {kern} > {RECON_RATIO} x {plain}")

    fwd_ms = cuda_ms(lambda: cuda_engine.forward_cuda_plan(
        plan, *inputs, save_strips=True), 3)
    bwd_ms = cuda_ms(lambda: cuda_engine.backward_cuda_plan(plan, *res), 3)
    fb, fb_by = bound(cfg, S, FWD_OPS_PER_CELL_STEP, fwd_bytes)
    bb, bb_by = bound(cfg, S, BWD_OPS_PER_CELL_STEP, bwd_bytes)
    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * S
    print(f"{tag} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, {S} shot(s), {rs.n_rec} "
          f"receivers): forward with strips vs plain: max rel err data {d}, "
          f"strips {max(s)}, final {max(f)} < {tol}; gradients (d_lam, d_mu, "
          f"d_rho, d_stf) {err} < {GRAD_TOL}, a second backward bitwise "
          f"equal; reconstruction residual / peak |pr| kernel {kern:.6e}, "
          f"plain f32 {plain:.6e}; max |ett| {float(ett.max()):.6e}")
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


def _shots(inputs, a, b):
    """The inputs of shots a..b-1 alone."""
    return (*inputs[:3], *(t[a:b] for t in inputs[3:]))


def chunk_against_single_shots(tag, cfg, rs, inputs, shots):
    """All the shots of `inputs` in one forward with strips and one
    backward (cotangent: the data itself), then each of `shots` alone:
    shots do not interact, so its data, strips, final fields and d_stf must
    have the same bits.  A 32-bit offset into the chunk's strips, state or
    data would move the late shots' values and show here."""
    S = inputs[3].shape[0]
    plan = cuda_engine.plan_for(cfg, rs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    data, strips, final = cuda_engine.forward_cuda_plan(plan, *inputs,
                                                        save_strips=True)
    d_stf = cuda_engine.backward_cuda_plan(plan, *inputs, final, strips,
                                           data)[3]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(d_stf).all()), f"{tag} d_stf not finite")
    for k in shots:
        one = _shots(inputs, k, k + 1)
        d1, s1, f1 = cuda_engine.forward_cuda_plan(plan, *one,
                                                   save_strips=True)
        check(float(d1[:, 3].abs().max()) > 1e-6,
              f"{tag} shot {k}: no arrivals at the receivers")
        g1 = cuda_engine.backward_cuda_plan(plan, *one, f1, s1, d1)[3]
        check(float(g1.abs().max()) > 0, f"{tag} shot {k}: d_stf is zero")
        same = {"data": torch.equal(d1[0], data[k]),
                "strips": torch.equal(s1[0], strips[k]),
                "final fields": torch.equal(f1[:, 0], final[:, k]),
                "d_stf": torch.equal(g1[0], d_stf[k])}
        check(all(same.values()),
              f"{tag} shot {k} in the chunk differs from the shot alone: "
              f"{same}")
    print(f"{tag} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}): {S} shots in one forward "
          f"with strips and one backward, {strips.numel()} strip floats "
          f"(2^32 = {2 ** 32}), {final.numel() // 5 * 13} state floats; data, "
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
    assumed = in_flight * (parallel.strip_bytes_per_shot(cfg)
                           + parallel.state_bytes_per_shot(cfg))
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
    assumed = chunk * (parallel.strip_bytes_per_shot(cfg)
                       + parallel.state_bytes_per_shot(cfg))
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


def _profile(label, fn):
    """Device-time breakdown of fn() under torch.profiler: time per kernel,
    the device window from the first device event to the last, and its
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    and one one-shot gradient evaluation on each large grid."""
    cfg, rs, inputs = reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    _profile("one reference forward_cuda_plan",
             lambda: cuda_engine.forward_cuda_plan(plan, *inputs))
    _profile("one reference gradient evaluation",
             _gradient_fn(cfg, rs, inputs))
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
    shapes: the reference workload (K1, K1-strips, K2), the acquisition of
    examples/das_fwi_torch.py (K1-fiber), one shot of `invert` at 560x720,
    nt=2001 and one chunk of 2 shots at 814x2064, nt=2001 (K3, K4).
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
