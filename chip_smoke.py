"""Smoke test of sep2023_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from csrc/, holds each against its plain PyTorch version on the card
(the forward, the forward with boundary strips, the boundary-saving
adjoint, its reconstruction, the adjoint dot product; receiver rows and
point receivers; the reference workload and the large grids 560x720 and
814x2064; the tile-edge cases of TILE_EDGE_CASES, phase 20), drives the
main paths through them (`forward` and `invert` at
the reference workload, `invert` at 560x720, a chunked Marmousi-scale
gradient at 814x2064, the curved-fiber inversion of
examples/das_fwi_torch.py), checks the ElasticPropagator API, and prints
the device-time breakdown of a reference forward, a reference gradient, a
reference acoustic gradient, two large-grid gradients and a fiber gradient
at examples/das_fwi_torch.py's shapes (torch.profiler).  The elastic and
the acoustic forward are nt launches of one kernel each, recording inside
the fused step and in a record-only launch after the last step; the
elastic backward is nt launches, nt-1 fused reverse steps (which add point
receivers' cotangents themselves) and the shot sum, and so is the acoustic
backward; every phase that runs them checks those counts.  Phase 22 times
the shot sums alone (one body, csrc/shot_sum.cuh: the elastic and the
acoustic gradients' and the rtm image's) against their byte bound, one
PyTorch call and an empty launch; phase 6 shows them inside backwards.
Phase 23 runs the acoustic pair with the reference workload's receivers
given as points, beside the row on the same inputs.
The two large main paths are also held against the plain versions at their
own shapes (nt=2001, the main path's survey), and the 54-shot chunk of the
560x720 one, whose strip offsets pass 2^32, against the same shots run
alone, bit for bit.

The acoustic physics the same way: the kernels of csrc/acoustic_fwd.cu and
csrc/acoustic_bwd.cu (the 3-field forward, with and without strips, the
boundary-saving adjoint and its imaging variant) against their plain
versions on AC_CASES, the reference shape and the reference workload
(phase 17) and on the tile-edge cases of AC_TILE_EDGE_CASES (phase 21); at
the shapes of the JAX package's streamed acoustic pair, one shot at 560x720
and 814x2064 and a 112-shot chunk at 560x720 bit for bit against single
shots (phase 18); and their main paths with exact launch counts and no
plain call (phase 19): `forward --physics acoustic` at the reference
workload and at 560x720 with 64 shots, `rtm` at its defaults, the acoustic
gradient of the JAX package's bench at the reference workload and at the
two streamed shapes, and `rtm --physics elastic`, whose illumination runs
the fused elastic step with its illumination accumulator (held bit for
bit against imaging.source_illumination on the card).

The rest of `invert` on the same kernels, each run with exact launch
counts and no plain call: the reference's rock-physics scripts at their
265x385, nt=4001, 31-shot scale (phase 24: Main-004's --head rock_gassmann
with a falling loss.txt, its VRH variant and Main-005's --model rock), and
the conditioned misfits at the reference workload beside the plain L2
(phase 25: two --bands stages with --win, --src-update, --misfit xcorr and
--energy-weights; --invert-stf; --generate_data, then --para-json off the
files it wrote and --resume).

The examples' paths last: the forward with wavefield snapshots (the state
copied on the card every save_every steps) bit for bit against its plain
version, and examples/das_modeling_torch.py against the analytic solution
(phase 26); the examples at full width (phase 27: overthrust_das_torch at
its defaults, marmousi_scale_torch with all 24 shots at 814x2064,
neural_reparam_fwi_torch at its grid, make_figures_torch in full); and
`invert --optimizer ondevice` at the reference workload (phase 28); each
with exact launch counts and no plain call.

The shots sharded over a mesh that repeats the one card (phase 29): the
kernels' sharded loss against the unsharded one at the reference workload
over 2 and 4 shards, chunked inside the shards, at 814x2064 (2 shots,
nt=601), through cli.build_stage_loss with per-trace conditioning and on a
ragged survey, each with exact launch counts (per shard a forward with
strips and a backward), no plain call and a second evaluation bitwise
equal; make_forward(mesh=) bit for bit; and the shot x domain loss, the
boundary-saving adjoint on column blocks, against the plain local loss on
the whole grid, on a 2 x 2 mesh and at 814x2064, nt=1001, 2 shots on a
1 x 2 mesh, with both losses' peak memory.  Its seconds are those of
shards sharing one card, not a scaling.

The plain PyTorch engine on the card, where the JAX package runs its XLA
engine on its accelerator (phase 30): `invert --x64`, `invert --engine
xla` and `rtm --x64` on the card against the CPU, ElasticPropagator in
float64 on the card against the CPU, the float32 kernels' loss and
gradients at the reference workload against the float64 plain answer on
the card, and a survey no plan takes, which the JAX package runs on its
XLA engine: refused on the card under --engine auto and pallas and by
ElasticPropagator's default engine, and run in float32 by the plain engine
on the card when asked (`invert --engine xla`, over a mesh of the card,
ElasticPropagator(engine='xla'), each against the CPU; at full width
against float64).

The benchmark last (phase 31): `python -m sep2023_tpu_torch bench`
(bench_torch.py, bench.py's sections on the kernels) in a process of its
own at its default budget, every key of its line present and > 0, nothing
skipped, the card named; the line is echoed after a prefix.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 3,7,8,9,10,20   # those phases only
    python3 chip_smoke.py --phases 17,21           # the acoustic pair
    python3 chip_smoke.py --phases 22              # the shot sums
    python3 chip_smoke.py --phases 23              # acoustic points
    python3 chip_smoke.py --phases 24,25           # rock scale, conditioned
    python3 chip_smoke.py --phases 26,27,28        # the examples' paths
    python3 chip_smoke.py --phases 29              # shot sharding
    python3 chip_smoke.py --phases 30              # the plain engine
    python3 chip_smoke.py --phases 31              # the bench

Needs one CUDA device and nvcc; exits nonzero, printing no result, without
them.  Imports neither jax nor sep2023_tpu.  The last line of standard
output is {"ok": true, "device": {...}}; the line before it is the JSON
record of every kernel (launches on its main path, error, times, bound).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
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

from sep2023_tpu_torch import api, cli, das, imaging, models, parallel
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import _build, cuda_acoustic, cuda_engine
from sep2023_tpu_torch.ops import signal as sg
from sep2023_tpu_torch.ops.misfit import l2_misfit, make_preprocessed_l2
from sep2023_tpu_torch.testing import (AC_CASES, AC_INTERIOR,
                                       AC_TILE_EDGE_CASES, CORNER_INVERT,
                                       DOT_TOL, FIBER_CASES, GRAD_TOL,
                                       PLAIN_DEVICE_TOL,
                                       PLAIN_F32_DEVICE_TOL, RECON_RATIO,
                                       ROW_CASES, TILE_EDGE_CASES,
                                       TILE_EDGE_SEED, TINY_INVERT,
                                       ac_perturbed_cotangent, ac_problem,
                                       ac_row_problem, ac_tile_edge_problem,
                                       acoustic_args, adjoint_gap,
                                       api_problem, corner_api_problem,
                                       corner_survey, fiber_problem,
                                       grad_errors, invert_run,
                                       perturbed_cotangent,
                                       reconstruction_residual, rel_diff,
                                       repeated_shot_mesh, row_problem,
                                       strip_errors, tile_edge_problem)
from sep2023_tpu_torch.testing import max_rel as rel_err

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "examples"))
import das_fwi_torch  # noqa: E402  (examples/das_fwi_torch.py)
import das_modeling_torch  # noqa: E402
import marmousi_scale_torch  # noqa: E402
import neural_reparam_fwi_torch  # noqa: E402
import overthrust_das_torch  # noqa: E402

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
#   acoustic_bwd.cu: velocity phase 56 (2 transposed stencils and their
#     sums 12, 2 stencils 10, reconstruction 8, buoyancy cotangents and
#     gradients 16, 2 CPML adjoints x 5), pressure phase 49 (12, 10,
#     reconstruction 6, cotangent and gradient of lam 11, 10): 105; as the
#     imaging variant 102 (the 9 of the three gradients give way to the 6 of
#     the image and the illumination);
#   elastic_fwd.cu with the illumination accumulator: 102 and 3 (pr, its
#     square, the sum): 105.
# Each counts the work of a cell-step once: the fused kernels' recomputed
# halo is not work the function needs.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
FWD_OPS_PER_CELL_STEP = 102
BWD_OPS_PER_CELL_STEP = 215
AC_FWD_OPS_PER_CELL_STEP = 50
AC_BWD_OPS_PER_CELL_STEP = 105
AC_IMG_OPS_PER_CELL_STEP = 102
ILL_OPS_PER_CELL_STEP = FWD_OPS_PER_CELL_STEP + 3


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
            "LAUNCHES_ILL": cuda_engine,
            "LAUNCHES_AC": cuda_acoustic,
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


def forward_launches(cfg, acoustic=False):
    """Launches of one elastic (or acoustic) forward: nt, the nt-1 fused
    steps, each recording the state it reads, and the record-only
    launch."""
    n = (cuda_acoustic.launches_forward_acoustic(cfg) if acoustic
         else cuda_engine.launches_forward(cfg))
    check(n == cfg.nt, f"launches a forward: {n} for nt={cfg.nt}")
    return n


def backward_launches(cfg, rs):
    """Launches of one elastic backward: nt, the nt-1 fused reverse steps
    (a point receiver's cotangent added inside them) and the shot sum."""
    n = cuda_engine.launches_backward(cfg, rs)
    check(n == cfg.nt, f"launches_backward gives {n} for nt={cfg.nt}")
    return n


def forward_backward_counts(cfg, rs, eng):
    """The launch counters of one forward with strips and one backward of
    engine `eng` (ELASTIC or ACOUSTIC) on survey rs."""
    if eng.acoustic:
        fwd = forward_launches(cfg, acoustic=True)
        return {"LAUNCHES_AC": fwd, "LAUNCHES_AC_STRIPS": fwd,
                "LAUNCHES_AC_BWD":
                    cuda_acoustic.launches_backward_acoustic(cfg, rs)}
    fiber = isinstance(rs, cuda_engine.FiberSurvey)
    fwd = forward_launches(cfg)
    return {"LAUNCHES": fwd, "LAUNCHES_STRIPS": fwd,
            "LAUNCHES_FIBER": 1 if fiber else 0,
            "LAUNCHES_BWD": backward_launches(cfg, rs)}


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


def tile_plan():
    """The fused elastic kernels' tile plan as the library has it:
    (tile z, tile x, threads a block, forward and backward shared memory a
    block in bytes)."""
    plan = (ctypes.c_int * 5)()
    _build.load().elastic_tile_plan(plan)
    return tuple(plan)


def elastic_forward_blocks():
    """Blocks of fwd_step_kernel an SM of this device holds, as the
    library has it."""
    out = (ctypes.c_int * 1)()
    err = _build.load().elastic_forward_plan(out)
    check(err == 0, f"elastic_forward_plan: CUDA error {err}")
    return out[0]


def elastic_backward_blocks():
    """Blocks of bwd_step_kernel, with its dynamic shared memory, an SM of
    this device holds, as the library has it."""
    out = (ctypes.c_int * 1)()
    err = _build.load().elastic_backward_plan(out)
    check(err == 0, f"elastic_backward_plan: CUDA error {err}")
    return out[0]


def acoustic_plan(kind):
    """(static shared memory a block in bytes, blocks an SM of this device)
    of the fused acoustic `kind` kernel ('forward' or 'backward'), as the
    library has them."""
    out = (ctypes.c_int * 2)()
    err = getattr(_build.load(), f"acoustic_{kind}_plan")(out)
    check(err == 0, f"acoustic_{kind}_plan: CUDA error {err}")
    return tuple(out)


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {path}")
    tz, tx, threads, fwd_smem, bwd_smem = tile_plan()
    print(f"[2 build] fused elastic kernels: {tz}x{tx} tiles, {threads} "
          f"threads a block, shared memory a block {fwd_smem} B (forward, "
          f"static) and {bwd_smem} B (backward, dynamic)")
    blocks = {"fwd_step_kernel": elastic_forward_blocks(),
              "bwd_step_kernel": elastic_backward_blocks()}
    print(f"[2 build] fused elastic forward (fwd_step_kernel, recording "
          f"inside): {blocks['fwd_step_kernel']} blocks an SM; fused "
          f"elastic backward (bwd_step_kernel, point cotangents inside): "
          f"{blocks['bwd_step_kernel']} blocks an SM on "
          f"{torch.cuda.get_device_name(0)}")
    for kind, kernel in (("forward", "ac_fwd_step_kernel"),
                         ("backward", "ac_bwd_step_kernel")):
        smem, blocks[kernel] = acoustic_plan(kind)
        print(f"[2 build] fused acoustic {kind} ({kernel}): "
              f"{tz}x{tx} tiles, {threads} threads a block, {smem} B of "
              f"static shared memory a block, {blocks[kernel]} blocks an SM "
              f"on {torch.cuda.get_device_name(0)}")
    # ptxas -v: "Function properties for <mangled name>", then "N bytes
    # stack frame, N bytes spill stores, N bytes spill loads" and "Used N
    # registers, ..." for that kernel; a kernel template's bool and int
    # arguments follow its name (ac_sum_shots_kernel<false, 20>: the 4-byte
    # variant, 20 shots' loads issued before any add)
    name, spills, all_spills = None, "", {}
    for line in _build.build_log(path).read_text().splitlines():
        m = re.search(r"Function properties for .*?(?<=\d)([a-z_]+_kernel)"
                      r"(I(?:L[ib]\d+E)+E)?E", line)
        if m:
            name, spills = m.group(1), ""
            if m.group(2):
                name += "<" + ", ".join(
                    v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([ib])(\d+)E", m.group(2))
                ) + ">"
        elif "spill stores" in line and name:
            spills = line.split(":", 1)[-1].strip()
        elif "Used" in line and name:
            print(f"[2 build] {name}: {line.split(':', 1)[1].strip()}; "
                  f"{spills}")
            all_spills[name] = spills
            name = None
    # the blocks an SM that each fused kernel's __launch_bounds__ asks for,
    # and no spills: the recording and the point cotangents inside the
    # fused steps may cost neither
    for kernel, least in (("fwd_step_kernel", 3), ("bwd_step_kernel", 2),
                          ("ac_fwd_step_kernel", 4),
                          ("ac_bwd_step_kernel", 4)):
        check(blocks[kernel] >= least,
              f"{kernel} at {blocks[kernel]} blocks an SM, not {least}")
        check("0 bytes spill stores, 0 bytes spill loads"
              in all_spills.get(kernel, ""),
              f"{kernel} spills: {all_spills.get(kernel)}")


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
    reset_counts()
    out = cuda_engine.forward_cuda_plan(plan, *inputs)
    counts, _ = read_counts()
    check(counts_are(counts, {"LAUNCHES": forward_launches(cfg)}),
          f"reference workload: forward launch counters {counts}")
    ref = cuda_engine.forward_plain(cfg, rs, *inputs)
    rel, abs_err = max_rel(out, ref)
    check(max(rel) < TOL_LONG, f"reference workload: {rel} >= {TOL_LONG}")
    kernel_ms = cuda_ms(
        lambda: cuda_engine.forward_cuda_plan(plan, *inputs), 5)
    plain_ms = cuda_ms(lambda: cuda_engine.forward_plain(cfg, rs, *inputs), 1,
                       warm=False)
    print(f"[3 kernel vs plain] reference workload ({cfg.nz}x{cfg.nx}, "
          f"nt={cfg.nt}, 19 shots): max rel err per channel {rel} < "
          f"{TOL_LONG}, max abs err {abs_err}; {forward_launches(cfg)} "
          f"launches; per forward, CUDA events: "
          f"kernel {kernel_ms:.3f} ms (mean of 5), plain {plain_ms:.3f} ms "
          f"(1 run after the comparison's)")
    return abs_err, kernel_ms, plain_ms, max(rel)


def phase_main_path(cfg, plain_ms):
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        data = cli.main(["forward", "--data-dir", d])
        counts, plain_calls = read_counts()
        launches = counts["LAUNCHES"]
        # the command's warm-up forward and its timed one
        check_counts("[4 main path] forward", counts,
                     {"LAUNCHES": 2 * forward_launches(cfg)},
                     plain_calls)
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
    model, survey, _ = api_problem()
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
    reset_counts()
    out = cuda_engine.forward_cuda_plan(plan, *inputs, save_strips=True)
    counts, _ = read_counts()
    fwd = forward_launches(cfg)
    check(counts_are(counts, {"LAUNCHES": fwd, "LAUNCHES_STRIPS": fwd}),
          f"reference workload: strips launch counters {counts}")
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
    reset_counts()
    syn, strips, final = cuda_engine.forward_cuda_plan(plan, *inputs,
                                                       save_strips=True)
    ett = float(syn[:, 3].abs().max())
    check(ett > 1e-3, f"no arrivals at the receivers ({ett})")
    d = perturbed_cotangent(cfg, rs, inputs, syn)
    check(float(d.abs().max()) > 1e-3 * ett, "the cotangent is round-off")
    res = (*inputs, final, strips, d)
    out = cuda_engine.backward_cuda_plan(plan, *res)
    counts, _ = read_counts()
    # the forward with strips, the cotangent's forward, the backward
    want = forward_backward_counts(cfg, rs, ELASTIC)
    want["LAUNCHES"] *= 2
    want["LAUNCHES_FIBER"] *= 2
    check(counts_are(counts, want), f"forward, backward launch counters "
          f"{counts}, expected {want}")
    return res, out, cuda_engine.backward_plain(cfg, rs, *res), ett


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


def _invert(label, argv, cfg, rs, S, niter, *, exp=None, data_forwards=1,
            decreasing=True):
    """`invert` through cli.main with the counts set to 0 just before and
    read just after: the launch counts are exact, no plain version ran, the
    losses are finite and (decreasing=True, one stage) loss.txt decreases.
    cfg, rs, S: the run's grid, survey and shots; exp: its --exp-name (a
    new temporary directory when None); data_forwards: the forwards of the
    observed data (1 for a twin experiment, 0 when they are read).
    Returns (counts, summary, evaluations, chunks)."""
    with tempfile.TemporaryDirectory() as d:
        exp = exp or d
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = cli.main(["invert", *argv, "--niter", str(niter),
                        "--exp-name", exp])
        counts, plain_calls = read_counts()
        hist = np.loadtxt(os.path.join(exp, "Results", "loss.txt"), ndmin=2)
    n = out["n_evals"]
    chunks = len(parallel._chunks(S, out["shot_chunk"]))
    fwd = forward_launches(cfg)
    bwd = backward_launches(cfg, rs)
    # the twin data and each --src-update: one forward a chunk; an
    # evaluation: a forward with strips and a backward a chunk
    forwards = data_forwards + out["src_updates"]
    want = {"LAUNCHES": fwd * chunks * (forwards + n),
            "LAUNCHES_STRIPS": fwd * chunks * n,
            "LAUNCHES_BWD": bwd * chunks * n}
    check_counts(label, counts, want, plain_calls)
    loss = hist[-out["nit"]:, 1] if out["nit"] else hist[:0, 1]
    check(len(loss) == out["nit"] >= 1 and np.isfinite(hist[:, 1]).all(),
          f"{label} loss.txt {hist[:, 1]} for {out['nit']} iterations")
    if decreasing:
        check(len(loss) == niter and (np.diff(loss) < 0).all()
              and out["misfit"] <= loss[0], f"loss.txt not decreasing: {loss}")
    print(f"{label} loss.txt {loss.tolist()}"
          f"{' decreasing' if decreasing else ', finite'}; {n} gradient "
          f"evaluations in {out['stages']} stage(s), {chunks} shot chunk(s) "
          f"of {S} shots; launches = forward {fwd} x {chunks} x ({forwards} "
          f"+ {n}) = {counts['LAUNCHES']} (with strips "
          f"{counts['LAUNCHES_STRIPS']}), backward {bwd} x {chunks} x {n} = "
          f"{counts['LAUNCHES_BWD']}, as expected; plain calls "
          f"{plain_calls}")
    return counts, out, n, chunks


def phase_invert_main_path(cfg, rs):
    """`invert --niter 3` at the CLI defaults (the reference workload):
    (counts, seconds an evaluation)."""
    counts, out, n, _ = _invert("[11 main path] invert --niter 3:", [], cfg,
                                rs, 19, 3)
    per_eval = out["seconds"] / n
    cells = 165 * 265 * 1500 * 19
    print(f"[11 main path] {out['seconds']:.3f} s in L-BFGS-B, "
          f"{per_eval:.3f} s per gradient evaluation, "
          f"{cells / per_eval / 1e9:.2f} GCell/s gradient")
    return counts, per_eval


def _kernel_case(label, cfg, rs, inputs, seed=7):
    """The forward, the forward with strips and the backward against their
    plain versions on one problem: data, strips and final fields bitwise
    equal, gradients within GRAD_TOL, a second backward bitwise, the
    reconstruction residual equal to the plain f32 one, the adjoint dot
    product (its random pair drawn from `seed`), and the launch counters of
    each call.  Returns its printed summary."""
    fiber = isinstance(rs, cuda_engine.FiberSurvey)
    fwd = forward_launches(cfg)
    bwd = backward_launches(cfg, rs)
    plan = cuda_engine.plan_for(cfg, rs)
    reset_counts()
    out = cuda_engine.forward_cuda_plan(plan, *inputs, save_strips=True)
    data = cuda_engine.forward_cuda_plan(plan, *inputs)
    counts, _ = read_counts()
    check(counts_are(counts, {"LAUNCHES": 2 * fwd, "LAUNCHES_STRIPS": fwd,
                              "LAUNCHES_FIBER": 2 if fiber else 0}),
          f"{label}: forward launch counters {counts}")
    check(torch.equal(data, out[0]), f"{label}: strip saving changed the data")
    ref = cuda_engine.forward_plain_strips(cfg, rs, *inputs)
    d, s, f = strip_errors(out, ref)
    check(all(torch.equal(a, b) for a, b in zip(out, ref)),
          f"{label}: kernel vs plain not bitwise: {d} {s} {f}")
    ett = float(ref[0][:, 3].abs().max())
    check(ett > 1e-3, f"{label}: no arrivals at the receivers ({ett})")
    _, strips, final = out
    kern = reconstruction_residual(cfg, cuda_engine.reconstruct_cuda_plan(
        plan, *inputs, final, strips), data)
    plain = reconstruction_residual(cfg, cuda_engine.reconstruct_plain(
        cfg, rs, *inputs, final, strips), data)
    check(kern == plain, f"{label}: reconstruction residual {kern}, plain "
          f"f32 {plain}")
    del out, ref, data, strips, final
    res, g, g_ref, _ = _backward_pair(cfg, rs, inputs)
    err = grad_errors(g, g_ref, cfg)
    check(max(err) < GRAD_TOL, f"{label}: backward vs plain {err}")
    reset_counts()
    again = cuda_engine.backward_cuda_plan(plan, *res)
    counts, _ = read_counts()
    check(counts_are(counts, {"LAUNCHES_BWD": bwd}),
          f"{label}: backward launch counters {counts}")
    check(all(torch.equal(a, b) for a, b in zip(g, again)),
          f"{label}: a second backward run gave other bits")
    _, _, gap = adjoint_gap(cfg, rs, inputs, seed)
    check(gap <= DOT_TOL, f"{label}: adjoint gap {gap} > {DOT_TOL}")
    return (f"({cfg.nz}x{cfg.nx}, npml {cfg.npml}, nt={cfg.nt}, "
            f"{inputs[3].shape[0]} shots, {type(rs).__name__} of "
            f"{rs.n_rec}, {cfg.das_channel}): data, strips and final fields "
            f"bitwise equal to plain (max rel err {max(d + s + f)}); "
            f"(d_lam, d_mu, d_rho, d_stf) {err} < {GRAD_TOL}; a second "
            f"backward bitwise equal; reconstruction residual / peak |pr| "
            f"{kern:.6e}, equal to plain f32; adjoint gap {gap:.3e} <= "
            f"{DOT_TOL}; launches a forward {fwd} (the last recording "
            f"only), a backward {bwd} (the last the shot sum"
            f"{'; point cotangents inside the fused steps' if fiber else ''}"
            f"); max |ett| {ett:.6e}")


def _fiber_case(label, cfg, rs, inputs):
    print(f"[12 fiber vs plain] {label} "
          f"{_kernel_case(label, cfg, rs, inputs)}")


def phase_tile_edges(dev):
    """The fused kernels where their tile edges can bite (TILE_EDGE_CASES):
    each case through `_kernel_case`."""
    tz, tx = tile_plan()[:2]
    for name in TILE_EDGE_CASES:
        cfg, rs, inputs = tile_edge_problem(name, device=dev)
        tiles = (-(-cfg.nz // tz), -(-cfg.nx // tx))
        print(f"[20 tile edges] {name} ({tz}x{tx} tiles, {tiles[0]}x"
              f"{tiles[1]} a shot) "
              f"{_kernel_case(name, cfg, rs, inputs, TILE_EDGE_SEED)}")


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
    """K1-fiber: the point recording of the fused forward and the point
    cotangents of the fused reverse step against the plain versions on
    every FIBER_CASES
    problem and at the shapes of the fiber main path
    (examples/das_fwi_torch.py), where they are also timed: returns that
    case's (forward, backward) numbers."""
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
    reset_counts()
    out = eng.forward(plan, *inputs, save_strips=True)
    data, strips, final = out
    d_data = data.clone()
    res = (*inputs, final, strips, d_data)
    g = eng.backward(plan, *res)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counts, _ = read_counts()
    want = forward_backward_counts(cfg, rs, eng)
    check(counts_are(counts, want),
          f"{tag} launch counters {counts}, expected {want}")
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
    if eng.acoustic:
        check(all(torch.equal(a, b) for a, b in zip(out, ref)),
              f"{tag} forward vs plain not bitwise: {d} {s} {f}")
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
    check(not eng.acoustic or kern == plain,
          f"{tag} reconstruction residual {kern}, plain f32 {plain}")

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
          f"{'pr' if eng.acoustic else 'ett'}| {float(ett.max()):.6e}; "
          f"launches {want}")
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
    cfg, rs, inputs = reference_problem(dev, **grid)
    counts, out, n, chunks = _invert(
        "[14 main path, large grid] invert at 560x720, nt=2001, --niter 2:",
        argv, cfg, rs, 64, 2)
    per_eval = out["seconds"] / n
    cells = 560 * 720 * 2000 * 64
    peak = torch.cuda.max_memory_allocated()
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


# Main-004's grid (examples/004_fwi_rock_physics.sh): 265x385 padded,
# nt=4001, 31 shots, the rock scale of the JAX package's bench.
ROCK_GRID = dict(nz=201, nx=321, dz=10.0, dx=10.0, nt=4001, dt=0.001,
                 f0=15.0)


def phase_rock(dev):
    """The reference's rock-physics scripts through `invert` on the card:
    Main-004 (--head rock_gassmann, --niter 2, loss.txt falling), its VRH
    variant 00x (--head rock_vrh) and Main-005 (--model rock, the velocity
    head), one L-BFGS-B iteration each; seconds an evaluation, gradient
    GCell/s, the shot chunk and the peak memory of each.  Returns the
    counts and the numbers by run."""
    argv = [a for k, v in ROCK_GRID.items() for a in (f"--{k}", f"{v:g}")]
    cfg, rs, _ = reference_problem(dev, **ROCK_GRID)
    S = 31
    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * S
    runs = {}
    for name, flags, niter, decreasing in (
            ("Main-004 --head rock_gassmann", ["--head", "rock_gassmann"],
             2, True),
            ("00x --head rock_vrh", ["--head", "rock_vrh"], 1, False),
            ("Main-005 --model rock", ["--model", "rock"], 1, False)):
        label = f"[24 rock] invert {name} at 265x385, nt=4001:"
        counts, out, n, chunks = _invert(label, argv + flags, cfg, rs, S,
                                         niter, decreasing=decreasing)
        per_eval = out["seconds"] / n
        peak = torch.cuda.max_memory_allocated()
        print(f"{label} {out['seconds']:.3f} s in L-BFGS-B, {per_eval:.3f} s "
              f"per gradient evaluation, {cells / per_eval / 1e9:.2f} GCell/s"
              f" gradient; shot chunk {out['shot_chunk']} ({chunks} "
              f"chunk(s)); peak memory {peak / 1e9:.3f} GB; final misfit "
              f"{out['misfit']:.6e}")
        runs[name] = dict(counts=counts, s_per_eval=per_eval,
                          gcell_s=cells / per_eval / 1e9, evals=n,
                          peak_gb=peak / 1e9)
        torch.cuda.empty_cache()
    return runs


BANDS = "0,1e-4,2,6;0,1e-4,2,10"


def phase_conditioned(ref_cfg, ref_rs):
    """The conditioned misfits and the stage loop at the reference workload
    through `invert` on the card, beside the plain-L2 run of the defaults:
    two --bands stages with --win, --src-update (one forward more a stage),
    --misfit xcorr and --energy-weights (whose per-trace weights supersede
    the scalar window, as in the JAX package); --win with --misfit xcorr;
    --invert-stf; then --generate_data, `invert --para-json` off the
    para_file.json it wrote (the data read, not modelled) and the same with
    --resume.  Returns the numbers by run."""
    S = 19
    cells = ref_cfg.nz * ref_cfg.nx * (ref_cfg.nt - 1) * S
    runs = {}

    def run(name, argv, niter, **kw):
        label = f"[25 conditioned] invert {name}:"
        counts, out, n, _ = _invert(label, argv, ref_cfg, ref_rs, S, niter,
                                    **kw)
        per_eval = out["seconds"] / n
        print(f"{label} {per_eval:.3f} s per gradient evaluation, "
              f"{cells / per_eval / 1e9:.2f} GCell/s gradient")
        runs[name] = dict(counts=counts, s_per_eval=per_eval,
                          gcell_s=cells / per_eval / 1e9, evals=n,
                          src_updates=out["src_updates"])
        return out

    run("(plain L2, the defaults)", [], 2)
    name = ("--bands (2 stages) --win --src-update --misfit xcorr "
            "--energy-weights")
    run(name, ["--bands", BANDS, "--win", "50,1400", "--src-update",
               "--misfit", "xcorr", "--energy-weights"], 2, decreasing=False)
    check(runs[name]["src_updates"] == 2,
          "--src-update did not run once a stage")
    run("--win --misfit xcorr", ["--win", "50,1400", "--misfit", "xcorr"],
        2)
    run("--invert-stf", ["--invert-stf"], 2)
    with tempfile.TemporaryDirectory() as d:
        data, exp = os.path.join(d, "Data"), os.path.join(d, "exp")
        reset_counts()
        check(cli.main(["invert", "--data-dir", data, "--exp-name", exp,
                        "--generate_data"]) is None, "--generate_data")
        counts, plain_calls = read_counts()
        check_counts("[25 conditioned] invert --generate_data", counts,
                     {"LAUNCHES": forward_launches(ref_cfg)}, plain_calls)
        check(os.path.exists(os.path.join(data, "Shot_ett18.bin")),
              "--generate_data wrote no Shot files")
        para = os.path.join(data, "para_file.json")
        run("--para-json", ["--para-json", para], 2, exp=exp,
            data_forwards=0)
        run("--para-json --resume", ["--para-json", para, "--resume"], 2,
            exp=exp, data_forwards=0)
    return runs


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
    rs = parallel._cuda_plan(cfg, survey)[0].rs
    fwd_n = forward_launches(cfg)
    bwd_n = backward_launches(cfg, rs)
    want = {"LAUNCHES": fwd_n * n_chunks * 2,
            "LAUNCHES_STRIPS": fwd_n * n_chunks,
            "LAUNCHES_BWD": bwd_n * n_chunks}
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
          f"= forward {fwd_n} x {n_chunks} x 2 = {counts['LAUNCHES']} "
          f"(with strips {counts['LAUNCHES_STRIPS']}), backward {bwd_n} x "
          f"{n_chunks} = {counts['LAUNCHES_BWD']}, as expected; plain "
          f"calls {plain_calls}; {seconds:.3f} s per value and gradient, "
          f"{cells / seconds / 1e9:.2f} GCell/s gradient; peak memory "
          f"{peak / 1e9:.3f} GB, auto_shot_chunk assumes {assumed / 1e9:.3f} "
          f"GB for {chunk} shots in flight")
    del obs, grads, params
    torch.cuda.empty_cache()
    n = cfg.npml
    numbers = hold_against_plain(
        f"[15 large grid vs plain] the Marmousi-scale survey, its first "
        f"chunk of {chunk}", cfg, rs,
        (*true, stf[:chunk], survey.src_z[:chunk] + n,
         survey.src_x[:chunk] + n, survey.src_rxz[:chunk]), TOL_LONG)
    torch.cuda.empty_cache()
    return counts, numbers


def phase_fiber_main_path(dev):
    """examples/das_fwi_torch.py's main with maxiter=3 on the card."""
    cfg, rs, _ = das_fwi_problem(dev)
    fwd = forward_launches(cfg)
    bwd = backward_launches(cfg, rs)
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        t0 = time.perf_counter()
        first, last, n = das_fwi_torch.main(d, "cuda", maxiter=3)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, plain_calls = read_counts()
    # the twin data: one forward; an evaluation: a forward with strips and
    # a backward; a forward records its points inside its fused steps and
    # in one record-only launch, a backward adds their cotangents inside
    # its fused steps
    want = {"LAUNCHES": fwd * (1 + n), "LAUNCHES_STRIPS": fwd * n,
            "LAUNCHES_FIBER": 1 + n, "LAUNCHES_BWD": bwd * n}
    check_counts("[16 main path, fiber]", counts, want, plain_calls)
    check(np.isfinite(last) and last < first,
          f"the gauge misfit did not decrease: {first} -> {last}")
    print(f"[16 main path, fiber] das_fwi_torch.main(maxiter=3): gauge "
          f"misfit {first:.6e} -> {last:.6e}; {n} evaluations; launches = "
          f"forward {fwd} x (1 + {n}) = {counts['LAUNCHES']} (with "
          f"strips {counts['LAUNCHES_STRIPS']}, record-only "
          f"{counts['LAUNCHES_FIBER']}), backward {bwd} x {n} = "
          f"{counts['LAUNCHES_BWD']}, as expected; plain calls "
          f"{plain_calls}; {seconds:.3f} s in all")
    return counts


def _acoustic_forward_pair(label, cfg, rs, args):
    """acoustic_forward without strips and with them: the launch counters,
    the same data either way, and both bitwise equal to the plain version
    with strips.  Returns (the kernel's (data, strips, final), the
    errors)."""
    fwd = forward_launches(cfg, acoustic=True)
    plan = cuda_engine.plan_for(cfg, rs)
    reset_counts()
    out = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args,
                                                   save_strips=True)
    data = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args)
    counts, _ = read_counts()
    check(counts_are(counts, {"LAUNCHES_AC": 2 * fwd,
                              "LAUNCHES_AC_STRIPS": fwd}),
          f"{label}: forward launch counters {counts}")
    check(torch.equal(data, out[0]), f"{label}: strip saving changed the data")
    ref = cuda_acoustic.forward_plain_acoustic_strips(cfg, rs, *args)
    d, s, f = strip_errors(out, ref)
    check(all(torch.equal(a, b) for a, b in zip(out, ref)),
          f"{label}: kernel vs plain not bitwise: {d} {s} {f}")
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


def _acoustic_case(tag, label, cfg, rs, args, seed=7):
    """A small acoustic case: forward, strips and final fields bitwise,
    backward (cotangent: the L2 residual against the model with lam raised
    by 3%), a second backward bitwise, the adjoint dot product (its random
    pair drawn from `seed`), the reconstruction residual equal to the plain
    f32 one, the image.  `tag` heads the printed lines."""
    plan = cuda_engine.plan_for(cfg, rs)
    fwd = forward_launches(cfg, acoustic=True)
    (syn, strips, final), (d, s, f) = _acoustic_forward_pair(label, cfg, rs,
                                                             args)
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
    check(n == cfg.nt, f"{label}: launches_backward_acoustic gives {n} for "
          f"nt={cfg.nt}")
    check(counts_are(counts, {"LAUNCHES_AC_BWD": n}),
          f"{label}: backward launch counters {counts}")
    check(all(torch.equal(a, b) for a, b in zip(g, again)),
          f"{label}: a second backward run gave other bits")
    _, _, gap = adjoint_gap(cfg, rs, args, seed)
    check(gap <= DOT_TOL, f"{label}: adjoint gap {gap} > {DOT_TOL}")
    kern = reconstruction_residual(
        cfg, cuda_acoustic.reconstruct_cuda_acoustic_plan(
            plan, *args, final, strips), syn)
    plain = reconstruction_residual(
        cfg, cuda_acoustic.reconstruct_plain_acoustic(
            cfg, rs, *args, final, strips), syn)
    check(kern == plain,
          f"{label}: reconstruction residual {kern}, plain f32 {plain}")
    print(f"{tag} {label} ({cfg.nz}x{cfg.nx}, npml {cfg.npml}, nt={cfg.nt}, "
          f"{args[2].shape[0]} shots, {type(rs).__name__}, {rs.n_rec} "
          f"receivers): data, strips and final fields bitwise equal to plain "
          f"(max rel err {max(d + s + f)}); (d_lam, d_rho, d_stf) {err} < "
          f"{GRAD_TOL} on the tight interior less {AC_INTERIOR}; adjoint gap "
          f"{gap:.3e} <= {DOT_TOL}; a second backward bitwise equal; "
          f"reconstruction residual / peak |pr| {kern:.6e}, equal to plain "
          f"f32; launches a forward {fwd} (the last recording only), a "
          f"backward {n}")
    _acoustic_image_pair(f"{tag} {label}", cfg, rs, args, final, strips,
                         -cot)


def phase_acoustic_vs_plain(dev):
    """K5, K5 with strips, K6 and its imaging variant against their plain
    versions: AC_CASES, the reference shape (nt=301, 2 shots) and the
    reference workload, where they are timed: returns that case's (forward,
    forward with strips, backward, imaging) numbers."""
    tag = "[17 acoustic vs plain]"
    for name in AC_CASES:
        _acoustic_case(tag, name, *ac_problem(name, device=dev))
    _acoustic_case(tag, "reference shape nt=301",
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
    check(torch.equal(out, ref), f"{tag}: forward vs plain not bitwise {d}")
    abs_err = float((out - ref).abs().max())
    n_bytes = nbytes(*args[:3], out)
    del ref
    ms = cuda_ms(lambda: cuda_acoustic.forward_cuda_acoustic_plan(plan, *args),
                 5)
    b_ms, b_by = bound(cfg, 19, AC_FWD_OPS_PER_CELL_STEP, n_bytes)
    print(f"{tag} (19 shots): forward without strips bitwise equal to "
          f"plain (max rel err per channel {d}); CUDA events: kernel "
          f"{ms:.3f} ms "
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


def phase_acoustic_tile_edges(dev):
    """The fused acoustic kernels where their tile edges can bite
    (AC_TILE_EDGE_CASES): each case through `_acoustic_case`."""
    tz, tx = tile_plan()[:2]
    for name in AC_TILE_EDGE_CASES:
        cfg, rs, args = ac_tile_edge_problem(name, device=dev)
        tiles = (-(-cfg.nz // tz), -(-cfg.nx // tx))
        _acoustic_case(f"[21 acoustic tile edges] ({tz}x{tx} tiles, "
                       f"{tiles[0]}x{tiles[1]} a shot)", name, cfg, rs, args,
                       TILE_EDGE_SEED)


def phase_acoustic_points(dev, reps=3):
    """The acoustic pair with point receivers at full width: the bench's
    acoustic gradient at the reference workload (phase 19d: lam = rho
    2000^2, 19 shots, nt=1501) with its 181 receivers given as a
    FiberSurvey on the row's cells.  K5-strips and K6 held against their
    plain versions (hold_against_plain: forward bitwise, gradients, a
    second backward bitwise, the reconstruction residual equal to plain);
    the points record the row's data bit for bit; K6 on the points and on
    the row, the same cotangent, timed in turns (row, points, points, row)
    by CUDA events, and the same for the imaging variant after it is held
    against plain; then the main paths, each with the counts set to 0 just
    before and read just after: one gradient through
    propagate_cuda_acoustic_plan and one rtm_image_time_cuda_plan.  The
    main paths' launch checks come last, so that a tree whose point
    backward launches otherwise prints every number before it fails.
    Returns the numbers of the kernels line."""
    tag = "[23 acoustic points]"
    cfg, rs, args = acoustic_reference_problem(dev, vp=2000.0)
    fs = cuda_engine.make_fiber_survey(np.full(rs.n_rec, rs.rec_row),
                                       rs.rec_x0 + np.arange(rs.n_rec))
    label = (f"{tag} reference workload, lam = rho 2000^2, {fs.n_rec} point "
             "receivers on the row's cells")
    fwd, bwd = hold_against_plain(label, cfg, fs, args, TOL_LONG,
                                  silent_samples=0, eng=ACOUSTIC)
    plans = {"row": cuda_engine.plan_for(cfg, rs),
             "points": cuda_engine.plan_for(cfg, fs)}
    res = {}
    for name, plan in plans.items():
        syn, strips, final = cuda_acoustic.forward_cuda_acoustic_plan(
            plan, *args, save_strips=True)
        res[name] = (*args, final, strips, syn)
    check(all(torch.equal(a, b) for a, b in zip(res["row"][5:],
                                                res["points"][5:])),
          f"{label}: the points' data, strips or final fields differ from "
          "the row's")
    backward = {name: (lambda p=plan, r=res[name]:
                       cuda_acoustic.backward_cuda_acoustic_plan(p, *r))
                for name, plan in plans.items()}
    turns = ("row", "points", "points", "row")
    ms = [cuda_ms(backward[name], reps) for name in turns]
    row_ms, pts_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    steps = cfg.nt - 1
    print(f"{label}: backward (d_data = the data), CUDA events, means of "
          f"{reps} in turns row / points / points / row: "
          f"{' / '.join(f'{t:.3f}' for t in ms)} ms; points - row "
          f"{pts_ms - row_ms:.3f} ms, {1e3 * (pts_ms - row_ms) / steps:.3f} "
          f"us a reverse step")

    final, strips, syn = res["points"][5:]
    residual = -ac_perturbed_cotangent(cfg, fs, args, syn)
    img = _acoustic_image_pair(label, cfg, fs, args, final, strips,
                               residual, timed=True)
    lam, rho, stf, sz, sx = args
    vp = torch.sqrt(lam / rho).contiguous()
    image = {name: (lambda p=plan, r=res[name]:
                    cuda_acoustic.image_cuda_acoustic_plan(
                        p, vp, rho, stf, sz, sx, r[5], r[6], residual))
             for name, plan in plans.items()}
    ms = [cuda_ms(image[name], reps) for name in turns]
    print(f"{label}: imaging variant, CUDA events, means of {reps} in turns "
          f"row / points / points / row: "
          f"{' / '.join(f'{t:.3f}' for t in ms)} ms")
    del res, backward, image, syn, strips, final

    counts, _ = _counted_gradient(f"{tag} main path: the acoustic gradient "
                                  f"with {fs.n_rec} point receivers", cfg,
                                  fs, args, reps)
    reset_counts()
    img_out, ill = cuda_acoustic.rtm_image_time_cuda_plan(
        plans["points"], vp, rho, stf, sz, sx, residual, sum_shots=True)
    torch.cuda.synchronize()
    img_counts, plain_calls = read_counts()
    fwd_n = forward_launches(cfg, acoustic=True)
    check_counts(f"{tag} main path: rtm_image_time_cuda_plan", img_counts, {
        "LAUNCHES_AC": fwd_n, "LAUNCHES_AC_STRIPS": fwd_n,
        "LAUNCHES_AC_BWD": cfg.nt, "LAUNCHES_AC_IMG": cfg.nt}, plain_calls)
    check(bool(torch.isfinite(img_out).all() and torch.isfinite(ill).all())
          and float(img_out.abs().max()) > 0, f"{tag} image not finite")
    print(f"{tag} main path: rtm_image_time_cuda_plan with {fs.n_rec} point "
          f"receivers: image {tuple(img_out.shape)} finite; launches "
          f"{ {k: v for k, v in img_counts.items() if v} }: nt={cfg.nt} a "
          "backward, as expected; plain calls 0")
    torch.cuda.empty_cache()
    return dict(forward=fwd, backward=bwd, image=img, counts=counts,
                image_counts=img_counts)


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
    fwd = forward_launches(cfg, acoustic=True)
    bwd = cuda_acoustic.launches_backward_acoustic(cfg, rs)
    check(bwd == steps + 1, f"{label}: launches a backward {bwd}")
    reset_counts()
    g = gradient()
    torch.cuda.synchronize()
    counts, plain_calls = read_counts()
    check_counts(label, counts, {
        "LAUNCHES_AC": fwd, "LAUNCHES_AC_STRIPS": fwd,
        "LAUNCHES_AC_BWD": bwd}, plain_calls)
    gmax = [float(a.abs().max()) for a in g]
    check(all(bool(torch.isfinite(a).all()) for a in g) and min(gmax) > 0,
          f"{label}: gradient maxima {gmax}")
    del g
    ms = cuda_ms(gradient, reps, warm=False)
    S = args[2].shape[0]
    cells = cfg.nz * cfg.nx * steps * S
    print(f"{label} ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, {S} shot(s)): max "
          f"|gradient| (lam, rho) {gmax}; launches forward with strips "
          f"{steps} + 1 = {counts['LAUNCHES_AC']}, backward {steps} + 1 = "
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


def _illumination_vs_plain(cfg, rs, inputs):
    """illumination_cuda_plan against imaging.source_illumination on the
    card, shot by shot, bit for bit (the kernel rounds pr = szz + sxx and
    ill + pr * pr as the plain loop's elementwise ops do, on a forward that
    is bitwise equal to plain); then its CUDA-event time.  Returns the
    numbers of the kernels line."""
    lam, mu, rho, stf, sz, sx, rxz = inputs
    plan = cuda_engine.plan_for(cfg, rs)
    S = stf.shape[0]
    ill = cuda_engine.illumination_cuda_plan(plan, *inputs)
    geoms = cuda_engine._geoms(cfg, rs, sz, sx, rxz, lam.device, lam.dtype)
    ref, plain_ms = _timed(lambda: imaging.source_illumination(
        cfg, lam, mu, rho, stf, geoms))
    err = rel_err(ill, ref)
    check(float(ref.max()) > 0 and torch.equal(ill, ref),
          f"illumination kernel vs plain not bitwise: {err}")
    del ref
    ms = cuda_ms(lambda: cuda_engine.illumination_cuda_plan(plan, *inputs),
                 3)
    n_bytes = nbytes(lam, mu, rho, stf, ill)
    b_ms, b_by = bound(cfg, S, ILL_OPS_PER_CELL_STEP, n_bytes)
    print(f"[19e illumination vs plain] ({cfg.nz}x{cfg.nx}, nt={cfg.nt}, {S} "
          f"shots): illumination_cuda_plan bitwise equal to "
          f"imaging.source_illumination on every shot; CUDA events: kernel "
          f"{ms:.3f} ms (mean of 3), plain {plain_ms:.3f} ms (the "
          f"comparison's run); bound {b_ms:.3f} ms ({b_by}, "
          f"{n_bytes / 1e9:.3f} GB)")
    return dict(max_abs_err=0.0, max_rel_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


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
                     {"LAUNCHES_AC": 1501}, plain_calls)
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
                 counts, {"LAUNCHES_AC": 2001}, plain_calls)
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
        "LAUNCHES_AC": 3 * 1501, "LAUNCHES_AC_STRIPS": 1501,
        "LAUNCHES_AC_BWD": 1500 + 1, "LAUNCHES_AC_IMG": 1500 + 1}, 67)

    # (d) the bench's acoustic gradient at the reference workload
    bench = acoustic_reference_problem(dev, vp=2000.0)
    r["gradient"] = _counted_gradient(
        "[19d main path] the bench's acoustic gradient (lam = rho 2000^2)",
        *bench, 3)

    # (e) rtm --physics elastic: K1, K1 with strips and K2 with cotangents
    # on pr, vx and vz, then the illumination through the fused step (one
    # launch a step); then the illumination kernel against its plain
    # version on the card, on the reference survey at the same grid and nt
    cfg, rs, inputs = reference_problem(dev, nt=1001)
    fwd = forward_launches(cfg)
    r["rtm_elastic"] = _rtm(
        "[19e main path] rtm --physics elastic --nt 1001:",
        ["--physics", "elastic", "--nt", "1001"], {
            "LAUNCHES": 2 * fwd, "LAUNCHES_STRIPS": fwd,
            "LAUNCHES_BWD": backward_launches(cfg, rs),
            "LAUNCHES_ILL": cfg.nt - 1}, 67)
    r["illumination"] = _illumination_vs_plain(cfg, rs, inputs)

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
    """Device-time breakdown of fn() under torch.profiler: time per kernel
    (the shot sums always in rows of their own, however small), the device
    window from the first device event to the last, and its idle share; and
    the last launch of fwd_step_kernel and of ac_fwd_step_kernel apart from
    their others (a forward's record-only launch)."""
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
        if us < 1e-3 * busy and "sum_shots_kernel" not in name:
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
    for kernel in ("fwd_step_kernel", "ac_fwd_step_kernel"):
        us = [t1 - t0 for t0, t1, name in spans if f"::{kernel}(" in name]
        if len(us) > 1:
            print(f"[6 profile] {label}: the last of {len(us)} {kernel} "
                  f"launches {us[-1]:.3f} us, the others "
                  f"{sum(us[:-1]) / (len(us) - 1):.3f} us each")


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
    one reference acoustic gradient evaluation, one one-shot gradient
    evaluation on each large grid, and one gradient evaluation at
    examples/das_fwi_torch.py's shapes (point receivers); then the backwards
    whose shot sums phase 22 times alone at its other shapes (a 2-shot
    gradient at 814x2064, a reference rtm image, a one-shot acoustic
    gradient at 814x2064), for the sums' device time inside them."""
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
    _profile("one gradient evaluation at das_fwi_torch's shapes (92x132, "
             "nt=500, 6 shots, 63 weighted points)",
             _gradient_fn(*das_fwi_problem(dev)))

    cfg, rs, (lam, mu, rho, stf, sz, sx, _) = large_problem(
        *LARGE_CASES["814x2064 row"], dev)
    two = (lam, mu, rho, stf.expand(2, cfg.nt).contiguous(), np.repeat(sz, 2),
           np.array([cfg.nx // 3, 2 * cfg.nx // 3]), np.ones(2))
    _profile(f"one gradient evaluation, 814x2064 row, nt={cfg.nt}, 2 shots",
             _gradient_fn(cfg, rs, two))
    del two
    torch.cuda.empty_cache()
    cfg, rs, args = acoustic_reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    lam, rho, stf, sz, sx = args
    vp = torch.sqrt(lam / rho).contiguous()
    residual = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args)
    _profile("one rtm image (rtm_image_time_cuda_plan, reference workload, "
             "19 shots, summed)",
             lambda: cuda_acoustic.rtm_image_time_cuda_plan(
                 plan, vp, rho, stf, sz, sx, residual, sum_shots=True))
    del residual
    _profile("one acoustic gradient evaluation, 814x2064 row, nt=601, 1 shot",
             _acoustic_gradient_fn(*ac_large_problem("814x2064 row", dev)))
    torch.cuda.empty_cache()


# The shot sums timed alone (phase 22): (kernel, per-shot planes, shots,
# grid) at the reference workload and at 814x2064 with the shots a main
# path has in flight there (the Marmousi-scale chunk of 2; the acoustic
# gradient of phase 19f, 1 shot), and the sum of `rtm`'s image and
# illumination (the imaging variant, 2 planes a shot).
SHOT_SUM_CASES = {
    "sum_shots_kernel, reference workload": ("elastic", 5, 19, (165, 265)),
    "sum_shots_kernel, 814x2064": ("elastic", 5, 2, (814, 2064)),
    "ac_sum_shots_kernel, reference workload": ("acoustic", 3, 19,
                                                (165, 265)),
    "ac_sum_shots_kernel, 814x2064": ("acoustic", 3, 1, (814, 2064)),
    "ac_sum_shots_kernel, rtm image": ("acoustic", 2, 19, (165, 265)),
}


def phase_shot_sums(dev, reps=100):
    """Each backward's last launch, the sum of its per-shot gradient planes
    over shots (sum_shots_kernel, ac_sum_shots_kernel), alone on seeded
    random planes of each SHOT_SUM_CASES shape: bitwise against a plain
    loop over shots in the kernel's order, then timed by CUDA events with
    L2 (50 MB) flushed before each call, as (flush + call) - flush over
    `reps` calls, beside its byte bound (the per-shot planes read once, the
    sum written once) and one PyTorch call, per_shot.sum(0) (time only: it
    sums in another order); and without the flush (L2-warm).  Last, the
    floor of any launch, timed the same way: an empty kernel of one block
    and of the blocks the reference acoustic sum launches (so the script
    run in an older tree, whose library has no empty kernel, prints every
    case's numbers before it stops there).  Returns the numbers of the
    kernels line by case."""
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(22)
    flush = torch.empty(2 ** 25, device=dev)    # 128 MB, past L2

    def cold_ms(fn):
        both = cuda_ms(lambda: (flush.zero_(), fn()), reps)
        return both - cuda_ms(flush.zero_, reps)

    numbers = {}
    for name, (kind, planes, S, (nz, nx)) in SHOT_SUM_CASES.items():
        per_shot = torch.randn((S, planes, nz, nx), generator=gen, device=dev)
        out = torch.empty((planes, nz, nx), device=dev)
        if kind == "elastic":
            launch = lambda: lib.elastic_sum_shots(
                per_shot.data_ptr(), out.data_ptr(), S, nz, nx, stream)
        else:
            launch = lambda: lib.acoustic_sum_shots(
                per_shot.data_ptr(), out.data_ptr(), S, planes, nz, nx,
                stream)

        def plain():
            acc = torch.zeros_like(out)
            for k in range(S):
                acc += per_shot[k]
            return acc

        check(launch() == 0, f"{name}: launch failed")
        ref = plain()
        check(torch.equal(out, ref), f"{name}: kernel vs plain loop not "
              f"bitwise: {rel_err(out, ref)}")
        lib_err = rel_err(out, per_shot.sum(0))
        ms, plain_ms, library_ms = (cold_ms(f) for f in
                                    (launch, plain, lambda: per_shot.sum(0)))
        warm_ms = cuda_ms(launch, reps)
        warm_library_ms = cuda_ms(lambda: per_shot.sum(0), reps)
        n_bytes = nbytes(per_shot, out)
        ops = S * planes * nz * nx
        b_ms, b_by = max((ops / PEAK_FP32 * 1e3, "operations"),
                         (n_bytes / PEAK_BYTES * 1e3, "bytes"))
        print(f"[22 shot sums] {name} ({S} shots x {planes} planes of "
              f"{nz}x{nx}): bitwise equal to the plain loop over shots, max "
              f"rel err against per_shot.sum(0) {lib_err:.3e}; CUDA events, "
              f"L2 flushed: kernel {ms:.4f} ms, plain loop {plain_ms:.4f} ms,"
              f" per_shot.sum(0) {library_ms:.4f} ms (means of {reps}); "
              f"L2-warm: kernel {warm_ms:.4f} ms, per_shot.sum(0) "
              f"{warm_library_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
              f"{n_bytes / 1e6:.3f} MB): the kernel at "
              f"{100 * b_ms / ms:.1f}% of it")
        numbers[name] = dict(max_abs_err=float((out - ref).abs().max()),
                             max_rel_err=0.0, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms)
        del per_shot, out, ref
    planes, _, (nz, nx) = SHOT_SUM_CASES[
        "ac_sum_shots_kernel, reference workload"][1:]
    for blocks in (1, -(-planes * nz * nx // 1024)):  # 4 outputs a thread
        empty = lambda: lib.empty_launch(blocks, stream)
        check(empty() == 0, "empty launch failed")
        print(f"[22 shot sums] the floor: an empty kernel of {blocks} "
              f"block(s) of 256 threads, CUDA events, L2 flushed "
              f"{cold_ms(empty):.4f} ms, L2-warm {cuda_ms(empty, reps):.4f} "
              f"ms (means of {reps}; the same launch path, through ctypes)")
    del flush
    torch.cuda.empty_cache()
    return numbers


# examples/das_modeling_torch.py's benchmark: 208x288 padded, nt=700, one
# shot and one receiver, a snapshot every 25 steps.
SNAPSHOT_EVERY = 25


def _snapshots_vs_plain(label, cfg, rs, inputs, save_every, reps=3):
    """snapshots_cuda_plan against snapshots_plain on the same card: data
    and every snapshot bit for bit, launches_forward of the snapshot config
    a call; both timed by CUDA events.  Returns the numbers of the kernels
    line."""
    plan = cuda_engine.plan_for(cfg, rs)
    cfg_s = cuda_engine.propagator.snapshot_config(cfg, save_every)
    reset_counts()
    data, snaps = cuda_engine.snapshots_cuda_plan(plan, *inputs,
                                                  save_every=save_every)
    torch.cuda.synchronize()
    counts, plain_calls = read_counts()
    check_counts(label, counts, {"LAUNCHES": forward_launches(cfg_s),
                                 "LAUNCHES_FIBER": int(
                                     isinstance(rs, cuda_engine.FiberSurvey))},
                 plain_calls)
    ref_data, ref_snaps = cuda_engine.snapshots_plain(cfg, rs, *inputs,
                                                      save_every)
    check(snaps.shape == ref_snaps.shape and torch.equal(snaps, ref_snaps)
          and torch.equal(data, ref_data),
          f"{label}: the snapshots or the data differ from plain")
    check(float(ref_snaps.abs().max()) > 0, f"{label}: zero snapshots")
    ms = cuda_ms(lambda: cuda_engine.snapshots_cuda_plan(
        plan, *inputs, save_every=save_every), reps)
    # the plain version has just run: no warm-up
    plain_ms = cuda_ms(lambda: cuda_engine.snapshots_plain(
        cfg, rs, *inputs, save_every), 1, warm=False)
    S = inputs[3].shape[0]
    b_ms, b_by = bound(cfg_s, S, FWD_OPS_PER_CELL_STEP,
                       nbytes(*inputs[:3]) + S * cfg_s.nt * 4
                       + nbytes(data, snaps))
    print(f"{label} {tuple(snaps.shape)} snapshots and data "
          f"{tuple(data.shape)} bitwise equal to plain; launches "
          f"{counts['LAUNCHES']} = launches_forward of nt={cfg_s.nt}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} "
          f"ms ({b_by})")
    return dict(max_abs_err=0.0, max_rel_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def phase_snapshots(dev):
    """The snapshot route on the card: against its plain version at
    das_modeling_torch's shapes and at the reference workload (a snapshot
    every 100 steps, 19 shots), then das_modeling_torch's
    solver_vs_analytic as a main path: nt launches of the snapshot config,
    no plain call, vz correlated with the analytic solution."""
    cfg, plan, inputs = das_modeling_torch.solver_problem(dev)
    numbers = _snapshots_vs_plain(
        "[26 snapshots vs plain] das_modeling_torch, 208x288, nt=700, every "
        f"{SNAPSHOT_EVERY}:", cfg, plan.rs, inputs, SNAPSHOT_EVERY)
    ref_cfg, ref_rs, ref_inputs = reference_problem(dev)
    _snapshots_vs_plain("[26 snapshots vs plain] reference workload, every "
                        "100:", ref_cfg, ref_rs, ref_inputs, 100, reps=1)
    torch.cuda.empty_cache()
    cfg_s = cuda_engine.propagator.snapshot_config(cfg, SNAPSHOT_EVERY)
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        t0 = time.perf_counter()
        out = das_modeling_torch.solver_vs_analytic(d, "cuda")
        seconds = time.perf_counter() - t0
        counts, plain_calls = read_counts()
    check_counts("[26 main path] das_modeling_torch", counts,
                 {"LAUNCHES": forward_launches(cfg_s)}, plain_calls)
    check(out["corr"] > 0.98, f"vz correlation {out['corr']}")
    print(f"[26 main path] das_modeling_torch.solver_vs_analytic: vz vs "
          f"analytic Uz correlation {out['corr']:.6f}, "
          f"{out['snaps_vz'].shape[0]} snapshots; launches "
          f"{counts['LAUNCHES']} = launches_forward of nt={cfg_s.nt}, as "
          f"expected; plain calls 0; {seconds:.3f} s")
    return dict(counts=counts, numbers=numbers)


def _example(label, run, cfg, shots, *, chunks=1, data_forwards=1,
             fiber=False, extra=None):
    """An example's main through `run()` with the counts set to 0 just
    before and read just after: an evaluation is a forward with strips and
    a backward a chunk, the observed data data_forwards forwards a chunk
    (extra: the launches its other work adds); no plain call.  Prints the
    seconds an evaluation, the gradient GCell/s and the peak memory beside
    what auto_shot_chunk assumes for the shots in flight.  Returns (the
    example's result, counts, evaluations)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, n, seconds = run()
    torch.cuda.synchronize()
    counts, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    fwd = forward_launches(cfg)
    bwd = backward_launches(cfg, None)
    want = {"LAUNCHES": fwd * chunks * (data_forwards + n),
            "LAUNCHES_STRIPS": fwd * chunks * n,
            "LAUNCHES_BWD": bwd * chunks * n}
    if fiber:
        want["LAUNCHES_FIBER"] = chunks * (data_forwards + n)
    for k, v in (extra or {}).items():
        want[k] = want.get(k, 0) + v
    check_counts(label, counts, want, plain_calls)
    in_flight = -(-shots // chunks)
    per_eval = seconds / n
    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * shots
    print(f"{label} {n} evaluations, launches "
          f"{ {k: v for k, v in counts.items() if v} } = forward {fwd} x "
          f"{chunks} chunk(s) x ({data_forwards} + {n}), backward {bwd} x "
          f"{chunks} x {n}, as expected; plain calls 0; {per_eval:.3f} s "
          f"an evaluation, {cells / per_eval / 1e9:.2f} GCell/s gradient; "
          f"peak memory {peak / 1e9:.3f} GB, auto_shot_chunk assumes "
          f"{assumed_bytes(cfg, in_flight) / 1e9:.3f} GB for {in_flight} "
          "shots in flight")
    return out, counts, n


def phase_examples(dev):
    """The examples at full width on the card, each a main path with exact
    launch counts and no plain call: overthrust_das_torch at its defaults
    (the weighted spline cable as points), marmousi_scale_torch at its
    grid with all 24 shots in chunks of 2 (n_iters cut to 1),
    neural_reparam_fwi_torch at its grid (n_steps cut to 10) and
    make_figures_torch in full."""
    import make_figures_torch  # matplotlib, for this phase alone

    runs = {}
    with tempfile.TemporaryDirectory() as d:
        # (a) overthrust_das_torch: 8 shots, 92x132, nt=501
        cfg, survey, *_ = overthrust_das_torch.problem()

        def overthrust():
            m = overthrust_das_torch.main(d, device="cuda")
            return m, m["n_evals"], m["seconds"]

        m, counts, n = _example("[27 overthrust_das_torch]", overthrust,
                                cfg, survey.n_shots, fiber=True)
        check(m["misfit1"] < m["misfit0"],
              f"overthrust misfit {m['misfit0']} -> {m['misfit1']}")
        print(f"[27 overthrust_das_torch] misfit {m['misfit0']:.6e} -> "
              f"{m['misfit1']:.6e} in {m['nit']} iterations, falling; "
              f"illuminated-zone |vp err| {m['zone_err0']:.2f} -> "
              f"{m['zone_err1']:.2f} m/s")
        runs["overthrust"] = counts
        torch.cuda.empty_cache()

        # (b) marmousi_scale_torch: 814x2064, nt=2001, 24 shots, chunks of 2
        cfg, survey, *_ = marmousi_scale_torch.problem()
        chunks = len(parallel._chunks(survey.n_shots, 2))

        def marmousi():
            m = marmousi_scale_torch.main(d, n_iters=1, device="cuda")
            return m, m["n_evals"], m["seconds"]

        m, counts, n = _example("[27 marmousi_scale_torch]", marmousi, cfg,
                                survey.n_shots, chunks=chunks)
        check(survey.n_shots == 24 and cfg.nz == 814 and cfg.nx == 2064,
              "Marmousi scale is 24 shots at 814x2064")
        check(m["misfit1"] < m["misfit0"],
              f"Marmousi misfit {m['misfit0']} -> {m['misfit1']}")
        print(f"[27 marmousi_scale_torch] 24 shots at 814x2064 in {chunks} "
              f"chunks of 2: misfit {m['misfit0']:.6e} -> "
              f"{m['misfit1']:.6e} in {m['nit']} iterations, falling; "
              f"in-anomaly |vp err| {m['anom_err0']:.2f} -> "
              f"{m['anom_err1']:.2f} m/s; observed data "
              f"{m['seconds_data']:.3f} s")
        runs["marmousi"] = counts
        torch.cuda.empty_cache()

        # (c) neural_reparam_fwi_torch: 165x265, nt=1001, 19 shots
        cfg, survey, *_ = neural_reparam_fwi_torch.problem(dev)

        def neural():
            m = neural_reparam_fwi_torch.main(d, n_steps=10, device="cuda")
            return m, len(m["losses"]), m["seconds"]

        m, counts, n = _example("[27 neural_reparam_fwi_torch]", neural,
                                cfg, survey.n_shots)
        losses = m["losses"]
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"neural losses {losses}")
        print(f"[27 neural_reparam_fwi_torch] Adam, 10 steps: loss "
              f"{losses[0]:.6e} -> {losses[-1]:.6e}, falling; mean |vp err| "
              f"{m['err0']:.2f} -> {m['err1']:.2f} m/s")
        runs["neural"] = counts
        torch.cuda.empty_cache()

        # (d) make_figures_torch in full: the gather's forward, the
        # snapshot movie, `rtm` (acoustic, one chunk) and 15 L-BFGS-B
        # iterations on the ett, vx and vz misfit
        cfg, survey, _, _ = cli.benchmark_problem(nz=64, nx=128, nt=501,
                                                  npml=24, device=dev)
        ac_nt = 800
        snap_cfg = cuda_engine.propagator.snapshot_config(cfg, 25)

        def figures():
            t0 = time.perf_counter()
            m = make_figures_torch.main([os.path.join(d, "figs")])
            return m, m["n_evals"], time.perf_counter() - t0

        m, counts, n = _example(
            "[27 make_figures_torch]", figures, cfg, survey.n_shots,
            extra={"LAUNCHES": forward_launches(snap_cfg),
                   "LAUNCHES_AC": 3 * ac_nt, "LAUNCHES_AC_STRIPS": ac_nt,
                   "LAUNCHES_AC_BWD": ac_nt, "LAUNCHES_AC_IMG": ac_nt})
        check(len(m["figures"]) == 4
              and all(os.path.getsize(f) > 0 for f in m["figures"]),
              f"figures {m['figures']}")
        check(m["misfit1"] < m["misfit0"],
              f"make_figures misfit {m['misfit0']} -> {m['misfit1']}")
        print(f"[27 make_figures_torch] {len(m['figures'])} figures "
              f"written; misfit {m['misfit0']:.6e} -> {m['misfit1']:.6e}, "
              f"falling (seconds an evaluation include the gather, the "
              f"snapshots, rtm and the plots)")
        runs["figures"] = counts
    return runs


def phase_invert_ondevice(cfg, rs, scipy_per_eval):
    """`invert --optimizer ondevice --niter 3` at the CLI defaults (the
    reference workload): the on-device L-BFGS's evaluations with exact
    launch counts, the loss falling, its seconds an evaluation beside
    phase 11's scipy L-BFGS-B."""
    label = "[28 main path] invert --optimizer ondevice --niter 3:"
    counts, out, n, _ = _invert(label, ["--optimizer", "ondevice"], cfg, rs,
                                19, 3)
    per_eval = out["seconds"] / n
    cells = 165 * 265 * 1500 * 19
    beside = ("not run in this call" if scipy_per_eval is None
              else f"{scipy_per_eval:.3f} s")
    print(f"[28 main path] {n} evaluations in 3 iterations, "
          f"{out['seconds']:.3f} s in the on-device L-BFGS, {per_eval:.3f} s "
          f"an evaluation ({cells / per_eval / 1e9:.2f} GCell/s gradient); "
          f"phase 11's scipy L-BFGS-B: {beside} an evaluation")
    return counts


# Phase 29's tolerances: the sharded value and gradients against the
# unsharded ones on the same inputs (float32; the shards' sums group the
# shots otherwise), the JAX package's production-shape rule
# (__graft_entry__.py:183-189); the shot x domain loss against the plain
# local loss (the same boundary-saving adjoint, on column blocks and on the
# whole grid) on the whole grid, and the growth of its peak memory over the
# local loss's.
SHARD_LOSS_TOL = 1e-6
SHARD_GRAD_TOL = 2e-5
DD_LOSS_TOL = 1e-5
DD_GRAD_TOL = 5e-4
DD_PEAK_RATIO = 1.5


def _value_and_grad(loss, model, rest, n_pad=0):
    """(value, gradients of model, seconds) of loss(*model', *rest), model'
    = model with stf's last row repeated n_pad times (the mesh's padding),
    the gradients those of the real shots'."""
    params = [a.detach().clone().requires_grad_() for a in model]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = loss(*params[:3], parallel._pad_rows(params[3], n_pad), *rest)
    grads = torch.autograd.grad(val, params)
    torch.cuda.synchronize()
    return val.detach(), grads, time.perf_counter() - t0


def _held(label, val, grads, ref_val, ref_grads, loss_tol, grad_tol):
    """Relative loss error and each gradient's max error over its max,
    checked against the tolerances."""
    loss_err = float((val - ref_val).abs() / ref_val.abs())
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(grads, ref_grads)]
    check(np.isfinite(loss_err) and loss_err <= loss_tol
          and all(np.isfinite(errs)) and max(errs) <= grad_tol,
          f"{label} against unsharded: loss {loss_err} (tol {loss_tol}), "
          f"gradients (lam, mu, rho, stf) {errs} (tol {grad_tol})")
    return loss_err, errs


def _sharded_case(label, cfg, survey, model, obs, mesh, *, shot_chunk=0,
                  aux=(), misfit_fn=None, ref=None, make_loss=None):
    """One value and gradient of make_cuda_sharded_misfit on `mesh` (or of
    make_loss(padded survey, padded geoms)) against make_cuda_misfit
    unsharded on the same inputs (ref: its (value, grads, seconds),
    computed when None, after a first evaluation that warms it), with exact
    launch counts (per shard and chunk a forward with strips and a
    backward), no plain call, and a second evaluation bitwise equal to the
    first.  Returns (counts, numbers)."""
    S, n = survey.n_shots, len(mesh)
    w = torch.ones(S, device=obs.device)
    if ref is None:
        local = parallel.make_cuda_misfit(cfg, survey, misfit_fn=misfit_fn,
                                          shot_chunk=shot_chunk)
        _value_and_grad(local, model, (obs, w, *aux))  # warm
        ref = _value_and_grad(local, model, (obs, w, *aux))
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device=obs.device)
    _, geoms_p, obs_p, w_p, aux_p = parallel.pad_shots(model[3], geoms, obs,
                                                       w, n, aux)
    survey_p = parallel.pad_survey(survey, n)
    n_pad = survey_p.n_shots - S
    if make_loss is None:
        loss = parallel.make_cuda_sharded_misfit(
            cfg, survey_p, mesh, misfit_fn=misfit_fn, n_trace_aux=len(aux),
            shot_chunk=shot_chunk)
    else:
        loss = make_loss(survey_p, geoms_p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    val, grads, seconds = _value_and_grad(loss, model, (obs_p, w_p, *aux_p),
                                          n_pad)
    counts, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rs = parallel._cuda_plan(cfg, survey_p)[0].rs
    chunks = len(parallel._chunks(survey_p.n_shots // n, shot_chunk))
    one = forward_backward_counts(cfg, rs, ELASTIC)
    want = {k: v * n * chunks for k, v in one.items()}
    check_counts(label, counts, want, plain_calls)
    loss_err, errs = _held(label, val, grads, ref[0], ref[1], SHARD_LOSS_TOL,
                           SHARD_GRAD_TOL)
    val2, grads2, seconds2 = _value_and_grad(loss, model,
                                             (obs_p, w_p, *aux_p), n_pad)
    check(torch.equal(val, val2)
          and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
          f"{label}: a second evaluation gave other bits")
    print(f"{label} {cfg.nz}x{cfg.nx}, nt={cfg.nt}, {S} shots over {n} "
          f"shards on one card ({survey_p.n_shots} with padding, {chunks} "
          f"chunk(s) a shard): loss {float(val):.6e}, rel err {loss_err:.3e} "
          f"<= {SHARD_LOSS_TOL}; gradients (lam, mu, rho, stf) "
          f"{[f'{e:.3e}' for e in errs]} <= {SHARD_GRAD_TOL} of each max; a "
          f"second evaluation bitwise equal; launches {counts} = {one} x {n} "
          f"shards x {chunks} chunk(s); plain calls {plain_calls}; "
          f"{seconds:.3f} s and {seconds2:.3f} s a sharded value and "
          f"gradient, {ref[2]:.3f} s unsharded (shards on one card, not "
          f"scaling); peak memory {peak / 1e9:.3f} GB")
    return counts, dict(seconds=seconds, seconds_again=seconds2,
                        unsharded_seconds=ref[2], peak_bytes=peak,
                        loss_err=loss_err, grad_errs=errs, nt=cfg.nt)


def phase_sharded(dev):
    """The shot sharding on the card (phase 29), the mesh repeating the one
    card: make_cuda_sharded_misfit against make_cuda_misfit (a) at the
    reference workload over 2 and 4 shards (the 4-shard mesh pads the 19
    shots to 20), (b) with shot_chunk=4 inside each shard, (c) with 2 shots
    at 814x2064, nt=601 (K3/K4's shape), (d) cli.build_stage_loss with a mesh
    and per-trace windows and weights, and make_forward(mesh=) bit for bit,
    (e) a ragged survey over 2 shards; (f) make_dd_misfit on a 2 x 2 mesh
    against the plain local loss on the card."""
    card = (dev,)
    out = {}
    cfg, survey, _, stf = cli.benchmark_problem(device=dev)
    stf = (stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=dev)
           ).contiguous()
    _, _, (lam, mu, rho, *_) = reference_problem(dev)
    model = (lam, mu, rho, stf)
    S = survey.n_shots
    fwd = parallel.make_forward(cfg, survey, use_kernels=True, device=dev)
    obs = fwd((lam * 1.03).contiguous(), mu, rho, stf)
    local = parallel.make_cuda_misfit(cfg, survey)
    _value_and_grad(local, model, (obs, torch.ones(S, device=dev)))  # warm
    ref = _value_and_grad(local, model, (obs, torch.ones(S, device=dev)))
    for n in (2, 4):
        out[f"a{n}"] = _sharded_case(f"[29a sharded, {n} shards]", cfg,
                                     survey, model, obs, card * n, ref=ref)
    out["b"] = _sharded_case("[29b sharded, chunked by 4]", cfg, survey,
                             model, obs, card * 2, shot_chunk=4, ref=ref)

    # (d) the CLI's builder with per-trace conditioning, and the forward
    rng = np.random.default_rng(29)
    R = survey.n_rec
    aux = tuple(torch.as_tensor(a, device=dev).float() for a in (
        rng.uniform(0, 200, (S, R)),
        rng.uniform(cfg.nt // 2, cfg.nt - 1, (S, R)),
        rng.uniform(0.5, 2.0, (S, R))))
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device=dev)
    build = lambda mesh: lambda sv, g: cli.build_stage_loss(
        cfg, sv, g, use_kernels=True, mesh=mesh, shot_chunk=0,
        channels=("ett",), per_trace=True)
    ref_d = _value_and_grad(build(None)(survey, geoms), model,
                            (obs, torch.ones(S, device=dev), *aux))
    fn = make_preprocessed_l2(channels=("ett",), dt=cfg.dt, per_trace=True)
    out["d"] = _sharded_case("[29d cli.build_stage_loss, 2 shards]", cfg,
                             survey, model, obs, card * 2, aux=aux,
                             ref=ref_d, make_loss=build(card * 2))
    reset_counts()
    fwd_mesh = parallel.make_forward(cfg, survey, use_kernels=True,
                                     mesh=card * 2, device=dev)
    obs_mesh = fwd_mesh((lam * 1.03).contiguous(), mu, rho, stf)
    torch.cuda.synchronize()
    counts, plain_calls = read_counts()
    check_counts("[29d make_forward(mesh=)]", counts,
                 {"LAUNCHES": forward_launches(cfg) * 2}, plain_calls)
    check(torch.equal(obs_mesh, obs), "[29d] make_forward(mesh=) differs "
          "from the unsharded forward")
    print(f"[29d make_forward(mesh=)] {S} shots over 2 shards ({S + S % 2} "
          f"with padding): bitwise equal to the unsharded forward; launches "
          f"{counts['LAUNCHES']} = {forward_launches(cfg)} x 2 shards; plain "
          f"calls {plain_calls}")
    del obs_mesh, ref, ref_d

    # (e) a ragged survey: 3 shots, their own spreads, over 2 shards
    nx = cfg.nx - 2 * cfg.npml
    row = int(survey.rec_z[0])
    kw = dict(src_z=np.array([1, 1, 1]), src_x=np.array([40, 100, 160]),
              rec_z=np.array([[row] * 150, [row - 5] * 150,
                              [row - 2] * 150]),
              rec_x=np.array([list(range(20, 140)) + [139] * 30,
                              list(range(30, 180)), list(range(25, 175))]),
              rec_live=np.array([[1.0] * 120 + [0.0] * 30, [1.0] * 150,
                                 [1.0] * 150]))
    check(int(kw["rec_x"].max()) < nx, "ragged survey off the grid")
    ragged = Survey(**kw)
    obs_r = parallel.make_forward(cfg, ragged, use_kernels=True, device=dev)(
        (lam * 1.03).contiguous(), mu, rho, stf[:3])
    tw = ragged.live_trace_weights()
    aux_r = tuple(torch.as_tensor(a, device=dev).float() for a in (
        np.zeros(tw.shape), np.full(tw.shape, cfg.nt - 1.0), tw))
    out["e"] = _sharded_case("[29e ragged, 2 shards]", cfg, ragged,
                             (lam, mu, rho, stf[:3].contiguous()), obs_r,
                             card * 2, aux=aux_r, misfit_fn=fn)
    del obs, obs_r
    torch.cuda.empty_cache()

    # (c) K3/K4's shape: 2 shots at 814x2064, nt=601, on the receiver row
    # of LARGE_CASES, where the wave arrives within nt
    cfg_l, rs_l, (lam_l, mu_l, rho_l, stf_l, *_) = large_problem(
        *LARGE_CASES["814x2064 row"], dev)
    p = cfg_l.npml
    survey_l = Survey(src_z=np.full(2, 1),
                      src_x=np.array([cfg_l.nx // 3, 2 * cfg_l.nx // 3]) - p,
                      rec_z=np.full(rs_l.n_rec, rs_l.rec_row - p),
                      rec_x=np.arange(rs_l.n_rec) + rs_l.rec_x0 - p)
    stf_l = stf_l.expand(2, cfg_l.nt).contiguous()
    obs_l = parallel.make_forward(cfg_l, survey_l, use_kernels=True,
                                  device=dev)(lam_l * 1.03, mu_l, rho_l,
                                              stf_l)
    out["c"] = _sharded_case("[29c sharded, 814x2064]", cfg_l, survey_l,
                             (lam_l, mu_l, rho_l, stf_l), obs_l, card * 2)
    del obs_l
    torch.cuda.empty_cache()
    out["f"] = _dd_case(dev)
    return out


def _dd_against_local(label, cfg, geoms, model, obs, mesh):
    """One value and gradient of make_dd_misfit on `mesh` against the plain
    local loss (make_local_misfit) on the card, on the whole grid: the
    plain step on the card, so no kernel launch and one
    PLAIN_CALLS["propagate_dd"] a mesh row.  Each one's peak memory is
    torch.cuda.max_memory_allocated since a reset just before it, and its
    growth over what was allocated then."""
    S = model[3].shape[0]
    w = torch.ones(S, device=obs.device)

    def measured(loss):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts()
        val, grads, seconds = _value_and_grad(
            lambda l, u, r, s, *a: loss(l, u, r, s, geoms, *a), model,
            (obs, w))
        counts, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated()
        return val, grads, seconds, counts, plain_calls, peak, peak - before

    ref = measured(parallel.make_local_misfit(cfg))
    val, grads, seconds, counts, plain_calls, peak, grown = measured(
        parallel.make_dd_misfit(cfg, mesh))
    check(counts_are(counts, {}) and plain_calls == {
        **{k: 0 for k in plain_calls}, "propagate_dd": len(mesh)},
        f"{label}: launches {counts}, plain calls {plain_calls}")
    loss_err, errs = _held(label, val, grads, ref[0], ref[1], DD_LOSS_TOL,
                           DD_GRAD_TOL)
    ratio = grown / ref[6]
    check(ratio <= DD_PEAK_RATIO, f"{label}: peak memory grew {grown} B, "
          f"{ratio:.3f}x the local loss's {ref[6]} B > {DD_PEAK_RATIO}")
    rows, cols = len(mesh), len(mesh[0])
    print(f"{label} {cfg.nz}x{cfg.nx}, nt={cfg.nt}, {S} shots on a {rows} x "
          f"{cols} mesh of the card ({rows} shot row(s), {cols} column "
          f"blocks of about {cfg.nx // cols} with 2 ghost columns a side): "
          f"loss {float(val):.6e}, rel err {loss_err:.3e} <= {DD_LOSS_TOL} "
          f"against the plain local loss; gradients (lam, mu, rho, stf) "
          f"{[f'{e:.3e}' for e in errs]} <= {DD_GRAD_TOL} of each max on "
          f"the whole grid; peak memory {peak / 1e9:.3f} GB, "
          f"{grown / 1e9:.3f} GB above the inputs, against the local loss's "
          f"{ref[5] / 1e9:.3f} GB, {ref[6] / 1e9:.3f} GB above "
          f"({ratio:.3f}x <= {DD_PEAK_RATIO}); {seconds:.3f} s a value and "
          f"gradient against {ref[2]:.3f} s for the local loss; no kernel "
          f"launch, plain calls {plain_calls}")
    return dict(seconds=seconds, local_seconds=ref[2], loss_err=loss_err,
                grad_errs=errs, peak_bytes=peak, local_peak_bytes=ref[5],
                grown_bytes=grown, local_grown_bytes=ref[6])


def _dd_case(dev):
    """Phase 29f: make_dd_misfit, the boundary-saving adjoint on column
    blocks, against the plain local loss on the card on the whole grid:
    4 shots at 92x132 (padded), nt=300, on a 2 x 2 mesh of the card; then
    2 shots at 814x2064, nt=1001, on a 1 x 2 mesh, the size the shot x
    domain split is for, which autograd through every block step could not
    hold (about 64 planes a step)."""
    nz, nx, nt, S, npml = 92, 132, 300, 4, 16
    cfg = SimConfig(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=nt, dt=0.001,
                    f0=15.0, npml=npml)
    pz, px = nz - 2 * npml, nx - 2 * npml
    survey = Survey(src_z=np.full(S, 2), src_x=np.linspace(10, px - 10,
                                                           S).astype(int),
                    rec_z=np.full(px - 8, pz - 10), rec_x=np.arange(4,
                                                                    px - 4))
    vp = np.full((pz, px), 2500.0)
    vp[pz // 2:, :] = 2900.0
    t = lambda a: torch.as_tensor(pad_model_np(a, npml), device=dev).to(
        torch.float32)
    med = Medium(t(vp), t(vp / np.sqrt(3.0)), t(np.full_like(vp, 2200.0)))
    lam, mu, rho = (a.contiguous() for a in med.to_lame())
    stf = torch.as_tensor(ricker(cfg.f0, nt, cfg.dt), device=dev).to(
        torch.float32).expand(S, nt).contiguous()
    geoms = parallel.survey_to_geoms(survey, npml, device=dev)
    obs = parallel.make_forward(cfg, survey, use_kernels=False, device=dev)(
        (lam * 1.03).contiguous(), mu, rho, stf)
    out = {"small": _dd_against_local(
        "[29f shot x domain]", cfg, geoms, (lam, mu, rho, stf), obs,
        parallel.mesh_2d(2, 2, devices=[dev] * 4))}
    del obs

    cfg_l, rs_l, (lam_l, mu_l, rho_l, stf_l, *_) = large_problem(
        814, 2064, 1001, "row", dev)
    p = cfg_l.npml
    survey_l = Survey(src_z=np.full(2, 1),
                      src_x=np.array([cfg_l.nx // 3, 2 * cfg_l.nx // 3]) - p,
                      rec_z=np.full(rs_l.n_rec, rs_l.rec_row - p),
                      rec_x=np.arange(rs_l.n_rec) + rs_l.rec_x0 - p)
    stf_l = stf_l.expand(2, cfg_l.nt).contiguous()
    obs_l = parallel.make_forward(cfg_l, survey_l, use_kernels=True,
                                  device=dev)(lam_l * 1.03, mu_l, rho_l,
                                              stf_l)
    out["814x2064"] = _dd_against_local(
        "[29f shot x domain, 814x2064]", cfg_l,
        parallel.survey_to_geoms(survey_l, p, device=dev),
        (lam_l, mu_l, rho_l, stf_l), obs_l,
        parallel.mesh_2d(1, 2, devices=[dev] * 2))
    del obs_l
    torch.cuda.empty_cache()
    return out


# Phase 30's bounds on the float32 kernels' loss and gradients (lam, mu,
# rho on the interior less 2 cells, stf) against the float64 plain answer
# at the reference workload: about 5x and 10x the first measurement
# (1.9e-5; 1.0e-5 to 5.4e-5 of each max; PERF.md, PR 15).
F64_LOSS_TOL = 1e-4
F64_GRAD_TOL = 5e-4


def _captured(fn):
    """(fn()'s result, what it printed), the print passed on as well."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    sys.stdout.write(buf.getvalue())
    return out, buf.getvalue()


def _no_kernel(label, counts, plain_calls, *names):
    """No kernel launched and each plain engine call in `names` made."""
    check(counts_are(counts, {}) and all(plain_calls[k] > 0 for k in names),
          f"{label}: launches {counts}, plain calls {plain_calls}")


class CardRun(NamedTuple):
    """An invert_run on the card, counted and timed."""
    hist: np.ndarray     # its loss.txt
    model: dict          # its last model snapshot
    printed: str         # what it printed
    counts: dict         # its launch counters
    plain_calls: dict    # its plain-engine calls
    seconds: float       # its wall time
    peak_bytes: int      # its peak of allocated device memory less what
                         # was allocated just before it started


def _card_invert(argv, exp):
    """invert_run of argv on the card (--device cuda, the default) with the
    counts set to 0 just before it: a CardRun."""
    reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (hist, model, _), printed = _captured(lambda: invert_run(argv, exp))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    return CardRun(hist, model, printed, *read_counts(), seconds, peak)


def _plain_invert(tmp, tag, argv):
    """invert_run of argv on the card and on the CPU: (the CardRun,
    loss.txt error, the largest of the model's errors), each relative to
    the CPU's max."""
    run = _card_invert(argv, os.path.join(tmp, tag + "_card"))
    hist_c, model_c, _ = invert_run([*argv, "--device", "cpu"],
                                    os.path.join(tmp, tag + "_cpu"))
    check(run.hist.shape == hist_c.shape and len(hist_c) >= 1,
          f"{tag}: loss.txt {run.hist.shape} on the card, {hist_c.shape} on "
          "the CPU")
    return (run, rel_diff(run.hist[:, 1], hist_c[:, 1]),
            max(rel_diff(run.model[k], model_c[k]) for k in model_c))


def phase_plain_engine(dev):
    """Phase 30: the plain PyTorch engine on the card, where the JAX
    package runs its XLA engine on its accelerator.  (a) `invert --x64`
    and `invert --engine xla --x64` at the CPU tests' size against the
    same runs with --device cpu (loss.txt and the model to
    PLAIN_DEVICE_TOL), the engine line naming cuda:0 and float64, no kernel
    launch; `invert --engine xla` (float32) --generate_data against the
    CPU's data; `rtm --x64` (both physics) against the CPU; (b) at the
    reference workload one float64 value and gradient of the plain loss on
    the card against the float32 kernels' (make_cuda_misfit), held to
    F64_LOSS_TOL and F64_GRAD_TOL; (c) ElasticPropagator(dtype=float64,
    device='cuda').apply_gradient against device='cpu'; (d) a survey no
    plan takes, refused on the card in float32 under --engine auto and
    pallas and run there under --engine xla, on a mesh, through the api
    and at full width (`_unplanned`)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, flags in (("x64", ["--x64"]),
                           ("xla_x64", ["--engine", "xla", "--x64"])):
            t0 = time.perf_counter()
            run, loss_err, model_err = _plain_invert(
                tmp, tag, [*TINY_INVERT, *flags])
            plain_calls = run.plain_calls
            named = "engine: plain PyTorch (cuda:0, float64)" in run.printed
            label = f"[30a invert {' '.join(flags)}]"
            _no_kernel(label, run.counts, plain_calls, "propagate")
            check(named and loss_err <= PLAIN_DEVICE_TOL
                  and model_err <= PLAIN_DEVICE_TOL,
                  f"{label} on the card against the CPU: loss.txt "
                  f"{loss_err}, model {model_err} (tol {PLAIN_DEVICE_TOL}); "
                  f"engine line named: {named}")
            print(f"{label} --device cuda against --device cpu at "
                  f"{' '.join(TINY_INVERT)}: loss.txt {loss_err:.3e}, model "
                  f"{model_err:.3e} <= {PLAIN_DEVICE_TOL} relative; engine "
                  f"line 'plain PyTorch (cuda:0, float64)'; no kernel "
                  f"launch; plain calls {plain_calls}; both runs "
                  f"{time.perf_counter() - t0:.1f} s")
            out[tag] = (loss_err, model_err)

        # float32 on the plain engine: the observed data of both devices
        data = {}
        for device in ("cuda", "cpu"):
            d = os.path.join(tmp, "xla32_" + device)
            reset_counts()
            (_, printed) = _captured(lambda: cli.main(
                ["invert", *TINY_INVERT, "--engine", "xla", "--device",
                 device, "--exp-name", d, "--generate_data", "--data-dir",
                 d]))
            if device == "cuda":
                counts, plain_calls = read_counts()
                _no_kernel("[30a invert --engine xla]", counts, plain_calls,
                           "propagate")
                check("engine: plain PyTorch (cuda:0, float32)" in printed,
                      "[30a invert --engine xla]: no engine line")
            survey = Survey.from_json(os.path.join(d, "survey_file.json"))
            data[device] = sio.read_shots_survey(d, survey, 80)
        err = max(rel_diff(data["cuda"][:, c], data["cpu"][:, c])
                  for c in range(4))
        check(err <= TOL, f"[30a invert --engine xla] data on the card "
              f"against the CPU {err} > {TOL}")
        print(f"[30a invert --engine xla] float32 --generate_data on the "
              f"card against the CPU: {err:.3e} <= {TOL} of each channel's "
              "max; engine line 'plain PyTorch (cuda:0, float32)'; no "
              "kernel launch")

        for physics, calls in (("acoustic", ("propagate_acoustic",
                                             "rtm_image_time")),
                               ("elastic", ("propagate",
                                            "source_illumination"))):
            argv = ["rtm", "--nz", "30", "--nx", "44", "--nt", "220",
                    "--npml", "8", "--x64", "--physics", physics]
            reset_counts()
            (img, ill, peak), printed = _captured(lambda: cli.main(
                [*argv, "--out", os.path.join(tmp, physics + ".npz")]))
            counts, plain_calls = read_counts()
            label = f"[30a rtm --x64 --physics {physics}]"
            _no_kernel(label, counts, plain_calls, *calls)
            img_c, ill_c, peak_c = cli.main(
                [*argv, "--device", "cpu", "--out",
                 os.path.join(tmp, physics + "_cpu.npz")])
            errs = (rel_diff(img, img_c), rel_diff(ill, ill_c))
            check("engine: plain PyTorch (cuda:0, float64)" in printed
                  and max(errs) <= PLAIN_DEVICE_TOL and peak == peak_c,
                  f"{label} on the card against the CPU: image, "
                  f"illumination {errs}, peak rows {peak}, {peak_c}")
            print(f"{label} on the card against the CPU: image "
                  f"{errs[0]:.3e}, illumination {errs[1]:.3e} <= "
                  f"{PLAIN_DEVICE_TOL}; muted-image peak row {peak} on both; "
                  f"no kernel launch; plain calls {plain_calls}")

        out["f64 gradient"] = _f64_gradient(dev)

        model, survey, init = api_problem()
        obs = api.ElasticPropagator(model, survey, device="cpu",
                                    dtype=torch.float64).apply_forward()
        reset_counts()
        card = api.ElasticPropagator(model, survey, device=dev,
                                     dtype=torch.float64)
        got = card.apply_gradient(init, obs)
        counts, plain_calls = read_counts()
        _no_kernel("[30c api]", counts, plain_calls, "propagate")
        ref = api.ElasticPropagator(model, survey, device="cpu",
                                    dtype=torch.float64).apply_gradient(
            init, obs)
        errs = [abs(got["misfit"] - ref["misfit"]) / ref["misfit"]] + [
            rel_diff(got[k], ref[k])
            for k in ("grad_vp", "grad_vs", "grad_rho", "grad_stf")]
        check(card.rs is None and max(errs) <= PLAIN_DEVICE_TOL,
              f"[30c api] float64 on the card against the CPU: {errs}")
        print(f"[30c api] ElasticPropagator(dtype=torch.float64, "
              f"device='cuda').apply_gradient against device='cpu': misfit, "
              f"vp, vs, rho, stf {[f'{e:.3e}' for e in errs]} <= "
              f"{PLAIN_DEVICE_TOL}; no kernel launch; plain calls "
              f"{plain_calls}")

        out["unplanned"] = _unplanned(dev, tmp)
    return out


def _refused(label, fn, want):
    """fn() raises ValueError naming `want` before anything runs: no kernel
    launch and no plain engine call."""
    reset_counts()
    try:
        fn()
        raised = ""
    except ValueError as e:
        raised = str(e)
    counts, plain_calls = read_counts()
    check(want in raised and counts_are(counts, {})
          and not any(plain_calls.values()),
          f"{label}: raised {raised!r}; launches {counts}, plain calls "
          f"{plain_calls}")
    print(f"{label} refused before anything ran: {raised!r}")


def _unplanned(dev, tmp):
    """Phase 30d: a survey no plan takes (`corner_survey`: a receiver row
    and two corners of the padded grid), which the JAX CLI runs on its XLA
    engine under every --engine.  On the card `invert` in float32 under
    --engine auto and pallas, and ElasticPropagator(dtype=torch.float32,
    device='cuda'), raise before anything runs, naming the plain engine's
    way in (--engine xla, engine='xla').  That way runs it: `invert
    --engine xla` at CORNER_INVERT's size against --device cpu (loss.txt
    and the model to PLAIN_F32_DEVICE_TOL), its engine line naming cuda:0
    and float32, no kernel launch; the same with --n-devices 2 on a mesh
    that repeats the card (the plain sharded loss) against the unsharded
    loss at the starting model (loss.txt's first row); ElasticPropagator(
    engine='xla')'s apply_forward and apply_gradient on the card against
    device='cpu'; and at full width (the reference survey and the two
    corners on the CLI's default grid, 19 shots, nt=1501, --niter 1)
    float32 against float64 on the card at the starting model, to
    F64_LOSS_TOL."""
    tol = PLAIN_F32_DEVICE_TOL
    line = "engine: plain PyTorch (cuda:0, float32)"
    path = os.path.join(tmp, "corners.json")
    corner_survey(44, 64).to_json(path)
    argv = [*CORNER_INVERT, "--survey-json", path]
    for flags in ([], ["--engine", "pallas"]):
        _refused(f"[30d invert {' '.join(flags) or '--engine auto'}]",
                 lambda: invert_run([*argv, *flags],
                                    os.path.join(tmp, "refused")),
                 "--engine xla runs it")
    model, survey, init = corner_api_problem()
    _refused("[30d api engine='auto']",
             lambda: api.ElasticPropagator(model, survey, device=dev),
             "engine='xla' runs the plain propagator")

    xla = [*argv, "--engine", "xla"]
    run, loss_err, model_err = _plain_invert(tmp, "corners", xla)
    label = "[30d invert --engine xla, a survey no plan takes]"
    _no_kernel(label, run.counts, run.plain_calls, "propagate")
    check(line in run.printed and loss_err <= tol and model_err <= tol,
          f"{label} on the card against the CPU: loss.txt {loss_err}, "
          f"model {model_err} (tol {tol}); engine line named: "
          f"{line in run.printed}")
    print(f"{label} ({' '.join(xla)}) on the card against --device cpu: "
          f"loss.txt {loss_err:.3e}, model {model_err:.3e} <= {tol} "
          f"relative; '{line}'; no kernel launch; plain calls "
          f"{run.plain_calls}; {run.seconds:.2f} s on the card, peak "
          f"memory {run.peak_bytes / 1e6:.1f} MB over what was allocated")
    out = {"invert": (loss_err, model_err, run.seconds, run.peak_bytes)}

    real = parallel.shot_mesh
    parallel.shot_mesh = repeated_shot_mesh
    try:
        sharded = _card_invert([*xla, "--n-devices", "2"],
                               os.path.join(tmp, "corners_sharded"))
    finally:
        parallel.shot_mesh = real
    label = "[30d invert --engine xla --n-devices 2]"
    _no_kernel(label, sharded.counts, sharded.plain_calls, "propagate")
    hist = sharded.hist
    err0 = abs(hist[0, 1] - run.hist[0, 1]) / run.hist[0, 1]
    on_mesh = "multi-chip: 2-device shot mesh" in sharded.printed
    # the sharded loss adds its shots in another order: at the starting
    # model it is held to the unsharded loss, after L-BFGS-B's steps that
    # rounding has moved the iterates (5.6e-6 on the CPU)
    check(line in sharded.printed and on_mesh
          and hist.shape == run.hist.shape and err0 <= tol
          and hist[-1, 1] < hist[0, 1],
          f"{label} against the unsharded run: loss.txt {hist[:, 1]} "
          f"against {run.hist[:, 1]}, first row {err0} (tol {tol}); engine "
          f"line named: {line in sharded.printed}; on the mesh: {on_mesh}")
    print(f"{label}: the plain sharded loss on a mesh of 2 that repeats the "
          f"card; loss.txt's first row (the loss at the starting model) "
          f"{err0:.3e} <= {tol} of the unsharded run's, its last "
          f"{rel_diff(hist[-1, 1], run.hist[-1, 1]):.3e}; '{line}'; no "
          f"kernel launch; plain calls {sharded.plain_calls}; "
          f"{sharded.seconds:.2f} s")
    out["--n-devices 2"] = (err0, sharded.seconds)

    reset_counts()
    t0 = time.perf_counter()
    card = api.ElasticPropagator(model, survey, device=dev, engine="xla")
    obs = card.apply_forward()
    got = card.apply_gradient(init, obs)
    seconds = time.perf_counter() - t0
    counts, plain_calls = read_counts()
    _no_kernel("[30d api engine='xla']", counts, plain_calls, "propagate")
    cpu = api.ElasticPropagator(model, survey, device="cpu")
    ref = cpu.apply_gradient(init, obs)
    errs = [rel_diff(obs, cpu.apply_forward()),
            abs(got["misfit"] - ref["misfit"]) / ref["misfit"]] + [
        rel_diff(got[k], ref[k])
        for k in ("grad_vp", "grad_vs", "grad_rho", "grad_stf")]
    check(card.rs is None and cpu.rs is None and got["misfit"] > 0
          and max(errs) <= tol,
          f"[30d api engine='xla'] float32 on the card against the CPU: "
          f"{errs}")
    print(f"[30d api] ElasticPropagator(dtype=torch.float32, device='cuda', "
          f"engine='xla') on the survey no plan takes against device='cpu': "
          f"data, misfit, vp, vs, rho, stf {[f'{e:.3e}' for e in errs]} <= "
          f"{tol}; no kernel launch; plain calls {plain_calls}; "
          f"apply_forward and apply_gradient {seconds:.2f} s on the card")
    out["api"] = errs

    # full width: the CLI's default grid (101x201, npml 32, nt=1501) and
    # the reference survey's 19 shots and receiver row, with the corners
    path = os.path.join(tmp, "reference_corners.json")
    corner_survey(101, 201, 32, src_x=np.arange(10, 191, 10)).to_json(path)
    full = ["--niter", "1", "--engine", "xla", "--survey-json", path]
    runs = {}
    for tag, flags in (("float32", []), ("float64", ["--x64"])):
        runs[tag] = r = _card_invert([*full, *flags],
                                     os.path.join(tmp, "full_" + tag))
        label = f"[30d invert {' '.join(full[:4] + flags)}, full width]"
        _no_kernel(label, r.counts, r.plain_calls, "propagate")
        named = f"engine: plain PyTorch (cuda:0, {tag})" in r.printed
        chunk = re.search(r"shot-chunk auto: .*", r.printed)
        check(named and np.isfinite(r.hist).all() and len(r.hist) >= 1,
              f"{label}: loss.txt {r.hist}, engine line named: {named}")
        print(f"{label}: 19 shots, 183 receivers, 165x265, nt=1501; "
              f"{chunk.group(0) if chunk else 'shot-chunk: one chunk'}; "
              f"loss.txt {r.hist[:, 1].tolist()}; plain calls "
              f"{r.plain_calls}; {r.seconds:.2f} s on the card, peak "
              f"memory {r.peak_bytes / 1e9:.3f} GB over what was allocated")
    f32, f64 = runs["float32"].hist[0, 1], runs["float64"].hist[0, 1]
    err = abs(f32 - f64) / abs(f64)
    check(f64 > 0 and err <= F64_LOSS_TOL,
          f"[30d full width] float32 loss at the starting model {f32} "
          f"against float64 {f64}: {err} > {F64_LOSS_TOL}")
    print(f"[30d full width] the loss at the starting model (loss.txt's "
          f"first row), float32 on the card against float64 on the card: "
          f"{err:.3e} <= {F64_LOSS_TOL} relative")
    out["full width"] = {"loss_err": err, **{
        tag: (r.seconds, r.peak_bytes) for tag, r in runs.items()}}
    return out


def _f64_gradient(dev):
    """Phase 30b: at the reference workload one value and gradient of the
    plain loss (make_local_misfit) in float64 on the card against the
    float32 kernels' (make_cuda_misfit) on the same inputs: the loss's
    relative error and each gradient's largest error over its max (lam, mu,
    rho on the interior less 2 cells, stf on all of it)."""
    cfg, survey, _, stf = cli.benchmark_problem(device=dev)
    stf = (stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=dev)
           ).contiguous()
    _, _, (lam, mu, rho, *_) = reference_problem(dev)
    S = survey.n_shots
    obs = parallel.make_forward(cfg, survey, use_kernels=True, device=dev)(
        (lam * 1.03).contiguous(), mu, rho, stf)
    w = torch.ones(S, device=dev)
    kernels = parallel.make_cuda_misfit(cfg, survey)
    model = (lam, mu, rho, stf)
    _value_and_grad(kernels, model, (obs, w))  # warm
    val, grads, seconds = _value_and_grad(kernels, model, (obs, w))
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device=dev,
                                     dtype=torch.float64)
    local = parallel.make_local_misfit(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    val64, grads64, seconds64 = _value_and_grad(
        lambda l, u, r, s, *a: local(l, u, r, s, geoms, *a),
        tuple(a.double() for a in model), (obs.double(), w.double()))
    counts, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _no_kernel("[30b]", counts, plain_calls, "propagate")
    n = cfg.npml + 2
    inner = lambda g: [g[0][n:-n, n:-n], g[1][n:-n, n:-n], g[2][n:-n, n:-n],
                       g[3]]
    loss_err = float((val.double() - val64).abs() / val64.abs())
    errs = [float((a.double() - b).abs().max() / b.abs().max())
            for a, b in zip(inner(grads), inner(grads64))]
    print(f"[30b float64 plain on the card] reference workload ({S} shots, "
          f"{cfg.nz}x{cfg.nx}, nt={cfg.nt}): float32 kernels against the "
          f"float64 plain answer: loss {float(val64):.9e}, rel err "
          f"{loss_err:.3e} <= {F64_LOSS_TOL}; gradients (lam, mu, rho on the "
          f"interior less 2, stf) {[f'{e:.3e}' for e in errs]} <= "
          f"{F64_GRAD_TOL} of each max; {seconds64:.3f} s the float64 value "
          f"and gradient ({seconds:.3f} s the kernels'), peak memory "
          f"{peak / 1e9:.3f} GB; no kernel launch; plain calls "
          f"{plain_calls}")
    check(np.isfinite(loss_err) and loss_err <= F64_LOSS_TOL
          and all(np.isfinite(errs)) and max(errs) <= F64_GRAD_TOL,
          f"[30b] float32 kernels against float64: loss {loss_err}, "
          f"gradients {errs}")
    return dict(loss_err=loss_err, grad_errs=errs, seconds=seconds64,
                kernel_seconds=seconds, peak_bytes=peak)


# Every key of the bench's line: the flagship's and each section's
# (bench_torch.py), each a number that must be > 0.
BENCH_KEYS = ("forward_s", "forward_single_dispatch_s",
              "single_dispatch_GCell_per_s", "gradient_s",
              "gradient_GCell_per_s", "gradient_814x2064_GCell_per_s",
              "forward_814x2064_GCell_per_s", "rock_gradient_s_265x385x4001",
              "rock_gradient_GCell_per_s",
              "chunked_gradient_GCell_per_s_12shot_chunk4",
              "gradient_560x720_GCell_per_s",
              "acoustic_gradient_GCell_per_s", "plain_forward_s",
              "plain_forward_GCell_per_s",
              "gradient_814x2064_nt1001_GCell_per_s",
              "forward_814x2064_nt1001_GCell_per_s")


def phase_bench(dev):
    """Phase 31: `python -m sep2023_tpu_torch bench` (bench_torch.py) in a
    process of its own at the default budget, as a user runs it: exit 0,
    and a last JSON line with metric, value, unit and vs_baseline and every
    key of BENCH_KEYS in extra, each > 0, nothing skipped, a peak memory
    for each section, and the card named as torch and nvidia-smi name it
    (the bench itself checks that each kernel section launched exactly nt
    a forward and a backward and ran no plain version).  The line is
    echoed after a prefix.  Then the silent receiver row of its streamed
    sections: max |syn| of one forward at each of their shapes."""
    import bench_torch  # the repository root's bench_torch.py

    sections = ("flagship",
                *(name for name, _ in bench_torch.sections(None, None, dev)))
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items()
           if k not in ("SEP2023_TPU_BENCH_BUDGET_S", "SEP2023_TPU_PROFILE")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "sep2023_tpu_torch",
                          "bench"], capture_output=True, text=True, env=env,
                         timeout=600)
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"[31] bench exited {res.returncode}: "
          f"{res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    check(len(lines) == len(sections),
          f"[31] bench printed {len(lines)} JSON lines")
    line = json.loads(lines[-1])
    extra = line["extra"]
    check(line["unit"] == "GCell/s" and line["metric"] == bench_torch.METRIC
          and line["value"] > 0
          and line["vs_baseline"] == line["value"] / 1.0,
          f"[31] bench line {line}")
    missing = [k for k in BENCH_KEYS
               if not (isinstance(extra.get(k), float) and extra[k] > 0)]
    check(not missing, f"[31] bench keys missing or not > 0: {missing}")
    check(extra["skipped"] == [], f"[31] bench skipped {extra['skipped']}")
    check(sorted(extra["peak_GB"]) == sorted(sections),
          f"[31] peak memory of {sorted(extra['peak_GB'])}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    check(extra["device"] == torch.cuda.get_device_name(0)
          and f"{extra['device']}, {extra['power_limit']}" == smi.strip(),
          f"[31] bench names {extra['device']!r}, "
          f"{extra['power_limit']!r}; nvidia-smi {smi!r}")
    print(f"[31] bench, {seconds:.1f} s wall: {lines[-1]}")
    silent = {}
    with torch.no_grad():
        for nz, nx, nt in ((814, 2064, 601), (560, 720, 1001),
                           (814, 2064, 1001)):
            p = bench_torch.stream_problem(nz, nx, nt, device=dev)
            syn = cuda_engine.forward_cuda_plan(p.plan, *p.args, *p.src)
            silent[f"{nz}x{nx}, nt={nt}"] = float(syn.abs().max())
    print(f"[31] max |syn| on the streamed sections' row: {silent}")
    # whether a call of the flagship's and the gradient section's function
    # waits for the card: host seconds until it returns against the
    # seconds until the card is done, each after a warm call
    ref = bench_torch._build(dev)
    fwd = lambda: cuda_engine.forward_cuda_plan(  # noqa: E731
        ref.plan, *ref.lame, ref.stf, *ref.src)
    data = fwd()
    grad = bench_torch.misfit_value_and_grad(ref.cfg, ref.survey)
    w = torch.ones(ref.survey.n_shots, device=dev)
    returned = {}
    for name, fn in (("forward", fwd),
                     ("gradient", lambda: grad(*ref.lame, ref.stf, data,
                                               w))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        returned[name] = (t1 - t0, time.perf_counter() - t0)
    print("[31] seconds until a call returns, until the card is done: "
          + ", ".join(f"{k} {a:.4f}, {b:.4f}"
                      for k, (a, b) in returned.items()))
    return dict(line=line, seconds=seconds, silent=silent,
                returned=returned)


def kernel_record(results):
    """The JSON record of every kernel.  `launches` are the counts of the
    kernel's main path, read just after it ran from counts set to 0 just
    before; every other number was measured in this run at that main path's
    shapes: the reference workload (K1, K1-strips, K2; K5, K5-strips, K6 and
    its imaging variant), the acquisition of examples/das_fwi_torch.py
    (K1-fiber), examples/das_modeling_torch.py's benchmark (K1 with
    snapshots), one shot of `invert` at 560x720, nt=2001 and one chunk of 2
    shots at 814x2064, nt=2001 (K3, K4), `forward --physics acoustic` at
    560x720, nt=2001, 64 shots and the one-shot acoustic gradients at
    560x720, nt=1001 and 814x2064, nt=601 (K7, K8); the shot sums alone at
    phase 22's shapes, each launched once by every backward of its main
    path (its launches: that path's backward launches over nt, the
    launches of one backward).  `sharded_launches` (K1-strips, K2, the
    reference workload's shot sum, and at 814x2064 K3 and K4) are those of
    the sharded main path of phase 29: one value and gradient over 2 shards
    at the reference workload, and at 814x2064 with 2 shots and nt=601.
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
                "replaces": replaces, "launches": launches,
                "library_ms": None, **numbers}

    kernels = [
        entry("elastic_forward (fwd_step_kernel: nt-1 fused steps recording "
              "inside, then its record-only launch)", fwd_src,
              fused + "875", r[4],
              dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=kernel_ms,
                   plain_ms=plain_ms, bound_ms=k1_bound, bound_by=k1_by)),
        entry("elastic_forward with boundary strips (fwd_step_kernel: nt-1 "
              "fused steps recording inside, then its record-only launch)",
              fwd_src, fused + "875", r[11][0]["LAUNCHES_STRIPS"],
              r[7]),
        entry("elastic_backward (fused reverse step, shot sum)", bwd_src,
              fused + "1186", r[11][0]["LAUNCHES_BWD"], r[8]),
        entry("elastic_forward with wavefield snapshots (fwd_step_kernel: "
              "nt-1 fused steps recording inside, the state copied on the "
              "card every 25 steps, then its record-only launch), "
              "examples/das_modeling_torch.py", fwd_src, fused + "875",
              r[26]["counts"]["LAUNCHES"], r[26]["numbers"]),
        entry("elastic_forward with point receivers and boundary strips "
              "(fwd_step_kernel: nt-1 fused steps recording the points by "
              "tile, then its record-only launch), the acquisition of "
              "examples/das_fwi_torch.py", fwd_src, fused + "875",
              r[16]["LAUNCHES_STRIPS"], r[12][0]),
        entry("elastic_backward with point receivers (fused reverse step "
              "adding the points' cotangents, shot sum), the acquisition of "
              "examples/das_fwi_torch.py", bwd_src, fused + "1186",
              r[16]["LAUNCHES_BWD"], r[12][1]),
    ]
    for shape, (counts, (fwd, bwd)) in (
            ("560x720, nt=2001, 1 shot", r[14]),
            ("814x2064, nt=2001, 2 shots", r[15])):
        kernels.append(entry(
            f"elastic_forward with boundary strips at {shape} "
            "(fwd_step_kernel: nt-1 fused steps recording inside, then its "
            "record-only launch), the streamed forward's shapes", fwd_src,
            stream + "1243",
            counts["LAUNCHES_STRIPS"], fwd))
        kernels.append(entry(
            f"elastic_backward at {shape}, the streamed backward's shapes",
            bwd_src, stream + "1794", counts["LAUNCHES_BWD"], bwd))

    ac_fwd_src = "sep2023_tpu_torch/csrc/acoustic_fwd.cu"
    ac_bwd_src = "sep2023_tpu_torch/csrc/acoustic_bwd.cu"
    k5, k5_strips, k6, k6_img = r[17]
    ac = r[19]
    kernels += [
        entry("elastic_illumination (fused step with the illumination "
              "accumulator, no record): imaging.source_illumination's route "
              "on the card, rtm --physics elastic --nt 1001", fwd_src,
              "sep2023_tpu/imaging.py:57", ac["rtm_elastic"]["LAUNCHES_ILL"],
              ac["illumination"]),
        entry("acoustic_forward (ac_fwd_step_kernel: nt-1 fused steps "
              "recording inside, then its record-only launch)", ac_fwd_src,
              fused + "1512", ac["forward"]["LAUNCHES_AC"], k5),
        entry("acoustic_forward with boundary strips (ac_fwd_step_kernel: "
              "nt-1 fused steps recording inside, then its record-only "
              "launch)", ac_fwd_src, fused + "1512",
              ac["gradient"][0]["LAUNCHES_AC_STRIPS"], k5_strips),
        entry("acoustic_backward (fused reverse step, shot sum)", ac_bwd_src,
              fused + "1746", ac["gradient"][0]["LAUNCHES_AC_BWD"], k6),
        entry("acoustic_backward, imaging variant (fused reverse step with "
              "the image and illumination accumulators, shot sum): "
              "acoustic.rtm_image_time's route on the card", ac_bwd_src,
              "sep2023_tpu/acoustic.py:224", ac["rtm"]["LAUNCHES_AC_IMG"],
              k6_img),
        entry("acoustic_forward at 560x720, nt=2001, 64 shots, the streamed "
              "acoustic forward's shapes", ac_fwd_src, stream + "2167",
              ac["forward_large"][0]["LAUNCHES_AC"], ac["forward_large"][1]),
    ]
    pts = r[23]
    points = "the reference workload's 181 receivers as a FiberSurvey"
    kernels += [
        entry("acoustic_forward with point receivers and boundary strips "
              "(ac_fwd_step_kernel: nt-1 fused steps recording the points by "
              f"tile, then its record-only launch), {points}", ac_fwd_src,
              fused + "1512", pts["counts"]["LAUNCHES_AC_STRIPS"],
              pts["forward"]),
        entry("acoustic_backward with point receivers (fused reverse step "
              f"adding the points' cotangents, shot sum), {points}",
              ac_bwd_src, fused + "1746", pts["counts"]["LAUNCHES_AC_BWD"],
              pts["backward"]),
        entry("acoustic_backward with point receivers, imaging variant "
              "(fused reverse step adding the points' cotangents, with the "
              f"image and illumination accumulators, shot sum), {points}",
              ac_bwd_src, "sep2023_tpu/acoustic.py:224",
              pts["image_counts"]["LAUNCHES_AC_IMG"], pts["image"]),
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

    sums = r[22]
    for name, source, replaces, bwd_launches, nt in (
            ("sum_shots_kernel, reference workload", bwd_src,
             fused + "1186", r[11][0]["LAUNCHES_BWD"], 1501),
            ("sum_shots_kernel, 814x2064", bwd_src, stream + "1794",
             r[15][0]["LAUNCHES_BWD"], 2001),
            ("ac_sum_shots_kernel, reference workload", ac_bwd_src,
             fused + "1746", ac["gradient"][0]["LAUNCHES_AC_BWD"], 1501),
            ("ac_sum_shots_kernel, 814x2064", ac_bwd_src, stream + "2493",
             ac["814x2064 row"][0]["LAUNCHES_AC_BWD"], 601),
            ("ac_sum_shots_kernel, rtm image", ac_bwd_src,
             "sep2023_tpu/acoustic.py:224", ac["rtm"]["LAUNCHES_AC_IMG"],
             1501)):
        kind, planes, S, _ = SHOT_SUM_CASES[name]
        kernels.append(entry(
            f"{name}, {S} shot(s) x {planes} planes: the backward's shot "
            "sum alone", source, replaces, bwd_launches // nt, sums[name]))
    # the sharded main path's launches (phase 29: 29a over 2 shards at the
    # reference workload, 29c over 2 shards at 814x2064, nt=601)
    sharded = {"K1-strips": r[29]["a2"][0]["LAUNCHES_STRIPS"],
               "K2": r[29]["a2"][0]["LAUNCHES_BWD"],
               "SUM": r[29]["a2"][0]["LAUNCHES_BWD"] // r[29]["a2"][1]["nt"],
               "K3": r[29]["c"][0]["LAUNCHES_STRIPS"],
               "K4": r[29]["c"][0]["LAUNCHES_BWD"]}
    for k in kernels:
        name = k["name"]
        if name.startswith("elastic_forward with boundary strips (") or \
                name.startswith("elastic_forward with boundary strips at "
                                "814x2064"):
            key = "K3" if "814x2064" in name else "K1-strips"
        elif name.startswith("elastic_backward (") or \
                name.startswith("elastic_backward at 814x2064"):
            key = "K4" if "814x2064" in name else "K2"
        elif name.startswith("sum_shots_kernel, reference workload"):
            key = "SUM"
        else:
            continue
        k["sharded_launches"] = sharded[key]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on its main path")
    return {"kernels": kernels}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke test of sep2023_tpu_torch "
                                 "on one NVIDIA GPU.")
    ap.add_argument("--phases", default="",
                    help="comma-separated phase numbers to run (1 and 2 "
                    "always run); the default runs every phase and prints "
                    "the kernels line and the result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    results = {"reference": reference_problem(dev)}
    ref_cfg, ref_rs, _ = results["reference"]
    phases = [
        (3, lambda: phase_kernel_vs_plain(dev)),
        (4, lambda: phase_main_path(ref_cfg, results[3][2])),
        (5, lambda: phase_api(dev)),
        (7, lambda: phase_strips_vs_plain(dev)),
        (8, lambda: phase_backward_vs_plain(dev)),
        (9, lambda: phase_adjoint_dot(dev)),
        (10, lambda: phase_reconstruction(dev)),
        (20, lambda: phase_tile_edges(dev)),
        (11, lambda: phase_invert_main_path(ref_cfg, ref_rs)),
        (12, lambda: phase_fiber_vs_plain(dev)),
        (13, lambda: phase_large_vs_plain(dev)),
        (14, lambda: phase_invert_large(dev)),
        (15, lambda: phase_marmousi_chunked(dev)),
        (16, lambda: phase_fiber_main_path(dev)),
        (17, lambda: phase_acoustic_vs_plain(dev)),
        (21, lambda: phase_acoustic_tile_edges(dev)),
        (18, lambda: phase_acoustic_large(dev)),
        (19, lambda: phase_acoustic_main_paths(dev, results[18])),
        (22, lambda: phase_shot_sums(dev)),
        (23, lambda: phase_acoustic_points(dev)),
        (24, lambda: phase_rock(dev)),
        (25, lambda: phase_conditioned(ref_cfg, ref_rs)),
        (26, lambda: phase_snapshots(dev)),
        (27, lambda: phase_examples(dev)),
        (28, lambda: phase_invert_ondevice(
            ref_cfg, ref_rs, results[11][1] if 11 in results else None)),
        (29, lambda: phase_sharded(dev)),
        (30, lambda: phase_plain_engine(dev)),
        (6, lambda: phase_profile(dev)),
        (31, lambda: phase_bench(dev)),
    ]
    only = {int(k) for k in args.phases.split(",") if k.strip()}
    for number, run in phases:
        if only and number not in only:
            continue
        t0 = time.perf_counter()
        results[number] = run()
        torch.cuda.synchronize()
        print(f"[{number}] phase took {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_start:.1f} s since the start)",
              flush=True)
    if only:
        print(f"phases {sorted(only)} passed; no kernels line or result "
              "line for a partial run")
        return
    print(json.dumps(kernel_record(results)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
