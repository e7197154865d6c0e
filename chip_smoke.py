"""Smoke test of sep2023_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from csrc/, holds each against its plain PyTorch version on the card
(the forward, the forward with boundary strips, the boundary-saving
adjoint, its reconstruction, the adjoint dot product), drives the `forward`
and `invert` commands at the reference workload through them, checks the
ElasticPropagator API, and prints the device-time breakdown of one
reference forward and one gradient evaluation (torch.profiler).

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits nonzero, printing no result, without
them.  Imports neither jax nor sep2023_tpu.  The last line of standard
output is {"ok": true, "device": {...}}; the line before it is the JSON
record of every kernel (launches on the main path, error, times, bound).
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

from sep2023_tpu_torch import api, cli, models, parallel
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch.config import Survey
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import _build, cuda_engine
from sep2023_tpu_torch.ops import signal as sg
from sep2023_tpu_torch.ops.misfit import l2_misfit
from sep2023_tpu_torch.testing import (DOT_TOL, GRAD_TOL, RECON_RATIO,
                                       ROW_CASES, adjoint_gap, grad_errors,
                                       perturbed_cotangent,
                                       reconstruction_residual, row_problem,
                                       strip_errors)

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


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, CUDA events, after one
    warm-up run."""
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


def reference_problem(dev):
    """The inputs `forward` builds at its defaults (101x201 + npml 32,
    nt=1501, 19 shots, 181 receivers at z=95)."""
    cfg, survey, geoms, stf = cli.benchmark_problem(device=dev)
    stf = stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=dev)
    vp, vs, rho = models.anomaly_vp_vs_rho(101, 201)
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
        ref = cuda_engine.forward_plain(cfg, rs, *inputs)
        ett = float(ref[:, 3].abs().max())
        check(ett > 1e-3, f"{name}: no arrivals at the receivers ({ett})")
        rel, _ = max_rel(cuda_engine.forward_cuda(cfg, rs, *inputs), ref)
        check(max(rel) < TOL, f"{name}: kernel vs plain {rel} >= {TOL}")
        print(f"[3 kernel vs plain] {name} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, "
              f"{inputs[3].shape[0]} shots): max rel err per channel "
              f"{rel} < {TOL}, max |ett| {ett:.6e}")

    cfg, rs, inputs = reference_problem(dev)
    out = cuda_engine.forward_cuda(cfg, rs, *inputs)
    ref = cuda_engine.forward_plain(cfg, rs, *inputs)
    rel, abs_err = max_rel(out, ref)
    check(max(rel) < TOL_LONG, f"reference workload: {rel} >= {TOL_LONG}")
    kernel_ms = cuda_ms(lambda: cuda_engine.forward_cuda(cfg, rs, *inputs), 5)
    plain_ms = cuda_ms(lambda: cuda_engine.forward_plain(cfg, rs, *inputs), 2)
    print(f"[3 kernel vs plain] reference workload ({cfg.nz}x{cfg.nx}, "
          f"nt={cfg.nt}, 19 shots): max rel err per channel {rel} < "
          f"{TOL_LONG}, max abs err {abs_err}; per forward, CUDA events: "
          f"kernel {kernel_ms:.3f} ms (mean of 5), plain {plain_ms:.3f} ms "
          f"(mean of 2)")
    return abs_err, kernel_ms, plain_ms


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
          f"phase 3's CUDA-event mean of 2: {plain_ms:.3f} ms, "
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
        out = cuda_engine.forward_cuda(cfg, rs, *inputs, save_strips=True)
        ref = cuda_engine.forward_plain_strips(cfg, rs, *inputs)
        d, s, f = strip_errors(out, ref)
        check(max(d + s + f) < TOL,
              f"{name}: strips kernel vs plain {d} {s} {f} >= {TOL}")
        print(f"[7 strips vs plain] {name} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}):"
              f" max rel err data per channel {d}, strips per field {s}, "
              f"final fields per field {f} < {TOL}")

    cfg, rs, inputs = reference_problem(dev)
    out = cuda_engine.forward_cuda(cfg, rs, *inputs, save_strips=True)
    ref = cuda_engine.forward_plain_strips(cfg, rs, *inputs)
    d, s, f = strip_errors(out, ref)
    check(max(d + s + f) < TOL_LONG,
          f"reference workload: strips {d} {s} {f} >= {TOL_LONG}")
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    n_bytes = nbytes(*inputs[:4], *out)
    del out, ref
    kernel_ms = cuda_ms(lambda: cuda_engine.forward_cuda(
        cfg, rs, *inputs, save_strips=True), 5)
    plain_ms = cuda_ms(lambda: cuda_engine.forward_plain_strips(
        cfg, rs, *inputs), 1)
    b_ms, b_by = bound(cfg, inputs[3].shape[0], FWD_OPS_PER_CELL_STEP,
                       n_bytes)
    print(f"[7 strips vs plain] reference workload ({cfg.nz}x{cfg.nx}, "
          f"nt={cfg.nt}, 19 shots): max rel err data {d}, strips {s}, final "
          f"{f} < {TOL_LONG}, max abs err {abs_err}; per forward with "
          f"strips, CUDA events: kernel {kernel_ms:.3f} ms (mean of 5), plain "
          f"{plain_ms:.3f} ms (1 after a warm-up); bound {b_ms:.3f} ms "
          f"({b_by}, {n_bytes / 1e9:.3f} GB)")
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def _backward_pair(cfg, rs, inputs):
    """backward_cuda and backward_plain fed the same strips, final fields
    and cotangent (the L2 residual of a model with lam raised by 3%)."""
    syn, strips, final = cuda_engine.forward_cuda(cfg, rs, *inputs,
                                                  save_strips=True)
    ett = float(syn[:, 3].abs().max())
    check(ett > 1e-3, f"no arrivals at the receivers ({ett})")
    d = perturbed_cotangent(cfg, rs, inputs, syn)
    check(float(d.abs().max()) > 1e-3 * ett, "the cotangent is round-off")
    res = (*inputs, final, strips, d)
    return res, cuda_engine.backward_cuda(cfg, rs, *res), \
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
    res, out, ref, ett = _backward_pair(cfg, rs, inputs)
    err = grad_errors(out, ref, cfg)
    check(max(err) < GRAD_TOL, f"reference workload: {err} >= {GRAD_TOL}")
    again = cuda_engine.backward_cuda(cfg, rs, *res)
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "a second backward run gave other bits")
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    n_bytes = nbytes(*res[:4], *res[7:], *out)
    del again
    del out, ref
    kernel_ms = cuda_ms(lambda: cuda_engine.backward_cuda(cfg, rs, *res), 3)
    plain_ms = cuda_ms(lambda: cuda_engine.backward_plain(cfg, rs, *res), 1)
    b_ms, b_by = bound(cfg, inputs[3].shape[0], BWD_OPS_PER_CELL_STEP,
                       n_bytes)
    print(f"[8 backward vs plain] reference workload ({cfg.nz}x{cfg.nx}, "
          f"nt={cfg.nt}, 19 shots): max rel err (d_lam, d_mu, d_rho, d_stf) "
          f"{err} < {GRAD_TOL}, max abs err {abs_err}, max |ett| {ett:.6e}, "
          f"a second run bitwise equal;"
          f" per backward, CUDA events: kernel {kernel_ms:.3f} ms (mean of 3),"
          f" plain {plain_ms:.3f} ms (1 after a warm-up); bound {b_ms:.3f} ms"
          f" ({b_by}, {n_bytes / 1e9:.3f} GB)")
    return dict(max_abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


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
    data, strips, final = cuda_engine.forward_cuda(cfg, rs, *inputs,
                                                   save_strips=True)
    kern = reconstruction_residual(cfg, cuda_engine.reconstruct_cuda(
        cfg, rs, *inputs, final, strips), data)
    plain = reconstruction_residual(cfg, cuda_engine.reconstruct_plain(
        cfg, rs, *inputs, final, strips), data)
    check(np.isfinite(kern) and kern <= RECON_RATIO * plain,
          f"reconstruction residual {kern} > {RECON_RATIO} x plain {plain}")
    print(f"[10 reconstruction] reference workload back to t=0: interior "
          f"stress residual / peak |pr|: kernel {kern:.6e}, plain f32 "
          f"{plain:.6e} (kernel <= {RECON_RATIO:g} x plain)")


def phase_invert_main_path():
    """`invert --niter 3` at the CLI defaults: the counts are set to 0
    just before and read just after."""
    steps = 1500
    with tempfile.TemporaryDirectory() as d:
        cuda_engine.LAUNCHES = 0
        cuda_engine.LAUNCHES_STRIPS = 0
        cuda_engine.LAUNCHES_BWD = 0
        for k in cuda_engine.PLAIN_CALLS:
            cuda_engine.PLAIN_CALLS[k] = 0
        out = cli.main(["invert", "--niter", "3", "--exp-name", d])
        launches = (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_STRIPS,
                    cuda_engine.LAUNCHES_BWD)
        plain_calls = dict(cuda_engine.PLAIN_CALLS)
        hist = np.loadtxt(os.path.join(d, "Results", "loss.txt"), ndmin=2)
    n = out["n_evals"]
    chunks = len(parallel._chunks(19, out["shot_chunk"]))
    want = (3 * steps * (1 + n * chunks), 3 * steps * n * chunks,
            (2 * steps + 1) * n * chunks)
    check(launches == want, f"invert launches (forward, of which with "
          f"strips, backward) {launches}, expected {want} for {n} "
          f"evaluations in {chunks} shot chunk(s)")
    check(sum(plain_calls.values()) == 0,
          f"invert called the plain versions: {plain_calls}")
    loss = hist[:, 1]
    check(len(loss) == 3 and np.isfinite(loss).all()
          and (np.diff(loss) < 0).all(), f"loss.txt not decreasing: {loss}")
    per_eval = out["seconds"] / n
    cells = 165 * 265 * steps * 19
    print(f"[11 main path] invert --niter 3: loss.txt {loss.tolist()} "
          f"decreasing; {n} gradient evaluations in {chunks} shot chunk(s);"
          f" launches: forward {launches[0]} (with strips {launches[1]}), "
          f"backward {launches[2]}, as expected; plain calls {plain_calls}")
    print(f"[11 main path] {out['seconds']:.3f} s in L-BFGS-B, "
          f"{per_eval:.3f} s per gradient evaluation, "
          f"{cells / per_eval / 1e9:.2f} GCell/s gradient")
    return launches


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
    for name, (n, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        print(f"[6 profile] {label}: {name[:60]}: {n} launches, "
              f"{us / 1e3:.3f} ms, {us / n:.3f} us each, "
              f"{100 * us / busy:.2f}% of busy")
    print(f"[6 profile] {label}: device window {window / 1e3:.3f} ms, busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / window:.4f}")


def phase_profile(dev):
    """One reference forward_cuda call, and one gradient evaluation as
    invert makes it (forward with strips, L2 misfit on ett, backward)."""
    cfg, rs, inputs = reference_problem(dev)
    _profile("one reference forward_cuda",
             lambda: cuda_engine.forward_cuda(cfg, rs, *inputs))
    lam, mu, rho, stf, sz, sx, rxz = inputs
    obs = cuda_engine.forward_cuda(cfg, rs, (lam * 1.03).contiguous(), mu,
                                   rho, stf, sz, sx, rxz)

    def gradient():
        params = [a.clone().requires_grad_() for a in (lam, mu, rho, stf)]
        syn = cuda_engine.propagate_cuda(cfg, rs, *params, sz, sx, rxz)
        return torch.autograd.grad(l2_misfit(obs, syn), params)

    _profile("one reference gradient evaluation", gradient)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    phase_environment()
    phase_build()
    abs_err, kernel_ms, plain_ms = phase_kernel_vs_plain(dev)
    fwd_launches = phase_main_path(plain_ms)
    phase_api(dev)
    strips = phase_strips_vs_plain(dev)
    bwd = phase_backward_vs_plain(dev)
    phase_adjoint_dot(dev)
    phase_reconstruction(dev)
    inv_launches = phase_invert_main_path()
    phase_profile(dev)
    cfg, _, inputs = reference_problem(dev)
    k1_bytes = nbytes(*inputs[:4]) + 19 * 4 * 181 * cfg.nt * 4
    k1_bound, k1_by = bound(cfg, 19, FWD_OPS_PER_CELL_STEP, k1_bytes)
    replaces = "sep2023_tpu/ops/pallas_engine.py:"
    print(json.dumps({"kernels": [
        {"name": "elastic_forward (stress, velocity, record)",
         "route": "cuda", "source": "sep2023_tpu_torch/csrc/elastic_fwd.cu",
         "replaces": replaces + "875", "launches": fwd_launches,
         "max_abs_err": abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "elastic_forward with boundary strips (stress, velocity, "
                 "record)",
         "route": "cuda", "source": "sep2023_tpu_torch/csrc/elastic_fwd.cu",
         "replaces": replaces + "875", "launches": inv_launches[1],
         **strips, "library_ms": None},
        {"name": "elastic_backward (velocity, stress, shot sum)",
         "route": "cuda", "source": "sep2023_tpu_torch/csrc/elastic_bwd.cu",
         "replaces": replaces + "1186", "launches": inv_launches[2],
         **bwd, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
