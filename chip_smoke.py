"""Smoke test of sep2023_tpu_torch on one NVIDIA GPU: builds the CUDA kernel
from csrc/, holds it against its plain PyTorch version on the card, drives
the `forward` command at the reference workload through it, checks the
ElasticPropagator API, and prints the device-time breakdown of one
reference forward (torch.profiler).

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits nonzero, printing no result, without
them.  Imports neither jax nor sep2023_tpu.  The last line of standard
output is {"ok": true, "device": {...}}; the line before it is the JSON
record of every kernel (launches on the main path, error, times).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sep2023_tpu_torch import api, cli, models
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch.config import Survey
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import _build, cuda_engine
from sep2023_tpu_torch.ops import signal as sg
from sep2023_tpu_torch.testing import ROW_CASES, row_problem

TOL = 2e-5          # per channel, relative to the channel max (f32 kernel
                    # vs f32 plain; the JAX package's Pallas-vs-XLA bound)
TOL_LONG = 1e-4     # nt=1501: FMA contraction and summation order differ,
                    # and the rounding differences accumulate over 1500 steps


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


def phase_profile(dev):
    """Device-time breakdown of one reference forward_cuda call under
    torch.profiler: time per kernel, the device window from the first
    device event to the last, and its idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, rs, inputs = reference_problem(dev)
    cuda_engine.forward_cuda(cfg, rs, *inputs)  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cuda_engine.forward_cuda(cfg, rs, *inputs)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:  # a measurement, not a gate: the phases above checked
        print("[6 profile] torch.profiler recorded no device events: "
              "breakdown not measured")
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
        print(f"[6 profile] {name[:60]}: {n} launches, {us / 1e3:.3f} ms, "
              f"{us / n:.3f} us each, {100 * us / busy:.2f}% of busy")
    print(f"[6 profile] one reference forward_cuda: device window "
          f"{window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / window:.4f}")


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    phase_environment()
    phase_build()
    abs_err, kernel_ms, plain_ms = phase_kernel_vs_plain(dev)
    launches = phase_main_path(plain_ms)
    phase_api(dev)
    phase_profile(dev)
    print(json.dumps({"kernels": [{
        "name": "elastic_forward (stress, velocity, record)",
        "route": "cuda",
        "source": "sep2023_tpu_torch/csrc/elastic_fwd.cu",
        "replaces": "sep2023_tpu/ops/pallas_engine.py:875",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
