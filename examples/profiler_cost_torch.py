"""What a torch.profiler trace of the port's kernels costs on the host, part
by part, with and without the CPU's events: the measurement behind
chip_smoke.py's choice to trace device activity only.

    python3 examples/profiler_cost_torch.py

Needs one CUDA device and nvcc.  For each workload of chip_smoke.py's
profile phase (a reference forward, a reference gradient, a reference
acoustic gradient, a one-shot gradient at 560x720 and at 814x2064, the
large grids at nt=401 and nt=301) it prints the seconds of a warm-up call,
of entering the profiler, of the traced call, of leaving the profiler, of
`prof.events()` and of collecting the device spans, then the number of
events, of device events, and the device's busy time.  On an NVIDIA H100
80GB HBM3 at 700 W, over two runs, `prof.events()` took 14 to 113 s for a
reference gradient's trace with the CPU's events in it and 0.9 to 1.5 s
without, for the same device events and the same busy time.
"""
from __future__ import annotations

import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402
from sep2023_tpu_torch.ops import cuda_engine  # noqa: E402

BOTH = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
DEVICE_ONLY = [ProfilerActivity.CUDA]


def cost(label, fn, activities):
    clock = time.perf_counter
    t0 = clock()
    fn()
    torch.cuda.synchronize()
    t1 = clock()
    prof = profile(activities=activities)
    prof.__enter__()
    t2 = clock()
    fn()
    torch.cuda.synchronize()
    t3 = clock()
    prof.__exit__(None, None, None)
    t4 = clock()
    events = prof.events()
    t5 = clock()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA)
    t6 = clock()
    busy = sum(b - a for a, b, _ in spans) / 1e3
    print(f"{label} {[a.name for a in activities]}: warm-up {t1 - t0:.2f} s, "
          f"enter {t2 - t1:.2f}, traced call {t3 - t2:.2f}, exit "
          f"{t4 - t3:.2f}, events() {t5 - t4:.2f}, spans {t6 - t5:.2f}; "
          f"{len(events)} events, {len(spans)} on the device, busy "
          f"{busy:.3f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    cfg, rs, inputs = cs.reference_problem(dev)
    plan = cuda_engine.plan_for(cfg, rs)
    forward = lambda: cuda_engine.forward_cuda_plan(plan, *inputs)
    cost("reference forward", forward, BOTH)
    cost("reference forward", forward, DEVICE_ONLY)
    gradient = cs._gradient_fn(cfg, rs, inputs)
    cost("reference gradient", gradient, DEVICE_ONLY)
    cost("reference gradient", gradient, BOTH)
    gradient = cs._acoustic_gradient_fn(
        *cs.acoustic_reference_problem(dev, vp=2000.0))
    cost("reference acoustic gradient", gradient, DEVICE_ONLY)
    cost("reference acoustic gradient", gradient, BOTH)
    cs.LARGE_ROW_DEPTH.update({401: 60, 301: 45})
    for name, nt in (("560x720 row", 401), ("814x2064 row", 301)):
        nz, nx, _, kind = cs.LARGE_CASES[name]
        cfg, rs, inputs = cs.large_problem(nz, nx, nt, kind, dev)
        gradient = cs._gradient_fn(cfg, rs, inputs)
        cost(f"{name}, nt={nt}", gradient, DEVICE_ONLY)
        cost(f"{name}, nt={nt}", gradient, BOTH)


if __name__ == "__main__":
    main()
