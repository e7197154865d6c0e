"""The benchmark of sep2023_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 fwibench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with one CUDA device.  The cell names a
configuration (`fwibench/configs/<config>.json`, its plain reference
`configs/<config>.py` beside it) and a traffic mix
(`fwibench/traffic/<traffic>.json`); each metric is read by
`fwibench/metrics/<metric>.py`, each compared number's limit is in
`fwibench/limits/<cell>.json`.  Set-up builds the problem through the
port, draws the inputs from the seed and warms up; the window runs the
mix for --seconds (to the end of the unit that crosses it); then the
port's state is freed and the plain reference judges what the window
produced.  The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones, from a device-only profile of a stretch
of the window), device, with --trace 1 breakdown, and last the compared
numbers with their limits (also the last lines of standard error).

Exits non-zero and prints no result without a CUDA device, when the port
cannot be imported, or when jax, jaxlib, flax or the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sep2023_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package's (compared whole: sep2023_tpu_torch is not sep2023_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def metric_reader(name: str):
    path = ROOT / "fwibench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "fwibench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones, or with trace its
    per-layer ones (a per-layer metric without `workloads` goes wherever
    the end-to-end metric it moves is reported)."""
    def has(m, e2e_names=None):
        if "workloads" in m:
            return cell in m["workloads"]
        return e2e_names is None or m["moves"] in e2e_names
    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if has(m, names)]


def power_limit() -> str | None:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             config: dict | None = None, marks: dict | None = None) -> dict:
    """One run of cell `name` on `device`; returns the result object.
    config stands in for the cell's configuration file (the CPU tests run
    one cut to a tiny size); marks: set-up clock readings taken before it,
    for the set-up line of standard error."""
    import numpy as np
    import torch

    from fwibench import inputs
    from fwibench.harness import drive, judge, readers
    from fwibench.harness import work as wk

    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cj = config or wk.load("configs", cell["config"])
    traffic = wk.load("traffic", cell["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kernels = sorted(p.stem for p in (wk.HERE / "kernels").glob("*.json"))

    marks = {**(marks or {}), "imports": time.perf_counter()}
    fields, noise = inputs.draw(cj, seed, dev)
    marks["inputs"] = time.perf_counter()
    prob = drive.build(cj, traffic, fields, dev)
    marks["build"] = time.perf_counter()
    kw = dict(device=dev, trace_kernels=kernels if trace else None)
    if traffic["kind"] == "invert":
        win, t_setup = drive.run_invert(prob, cj, traffic, noise, seconds,
                                        **kw)
    elif traffic["kind"] == "forward":
        win, t_setup = drive.run_forward(prob, traffic, seed, seconds, **kw)
    else:
        raise ValueError(f"no generator for traffic kind {traffic['kind']}")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    run = readers.Run(cj, traffic, t_setup - t_start, win, peak)

    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = metric_reader(m["name"])(run)
        if value is None:
            continue
        entry = value if isinstance(value, dict) else {"value": value}
        metrics[m["name"]] = {**entry, "unit": m["unit"]}

    # free the port's state before the reference runs
    del prob
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge.program_numbers(win, on_card, traffic["kind"])
    if traffic["kind"] == "invert":
        pick = judge.invert_sample(len(win.units), seed,
                                   traffic["checked_evaluations"])
        answers = [(win.units[i].x, win.units[i].f, win.units[i].g)
                   for i in pick]
        numbers.update(judge.reference_invert(cj, fields, noise, answers,
                                              win.x0, device=dev))
        failed = sum(1 for u in win.units if not (
            math.isfinite(u.f) and bool(np.isfinite(u.g).all())))
    else:
        numbers.update(judge.reference_forward(cj, fields,
                                               list(win.kept.values()),
                                               device=dev))
        failed = sum(1 for d in win.kept.values()
                     if not bool(torch.isfinite(d).all()))
    ok, checks = judge.verdict(numbers, judge.limits(name))

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": len(win.units), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace and win.trace is not None:
        t = win.trace
        dev_info.update(busy_s=t["busy_s"], window_s=t["window_s"],
                        traced_units=win.trace_units,
                        trace_first_unit=win.trace_first, events=t["events"])
        if on_card:
            dev_info["power_limit"] = power_limit()
        result["breakdown"] = {"device_ops": t["ops"],
                               "idle_gaps": t["gaps"]}
    print(f"cell {name} seed {seed}: {len(win.units)} units in "
          f"{win.t1 - win.t0:.3f} s, set-up {t_setup - t_start:.3f} s, "
          f"restarts {win.restarts}, shot chunk {prob_chunk(win)}, "
          f"reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    print(f"set-up: {setup_phases(t_start, {**marks, **win.marks})}; "
          f"window: {unit_times(win)}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result["checks"] = checks
    return result


def prob_chunk(win) -> str:
    """The shots of each chunk of one unit, as 19 or 12x12x7."""
    return "x".join(str(s) for s in win.chunks)


def setup_phases(t_start: float, marks: dict) -> str:
    """Seconds of each set-up phase, in order."""
    out, t = [], t_start
    for name, mark in sorted(marks.items(), key=lambda kv: kv[1]):
        out.append(f"{name} {mark - t:.3f} s")
        t = mark
    return ", ".join(out)


def unit_times(win) -> str:
    """The first unit's start, the units' shortest, median and longest
    time, and the longest gap between two units, in ms."""
    u = win.units
    d = sorted(x.t1 - x.t0 for x in u)
    gaps = [(b.t0 - a.t1, i) for i, (a, b) in enumerate(zip(u, u[1:]))]
    g, i = max(gaps) if gaps else (0.0, 0)
    return (f"first unit at +{(u[0].t0 - win.t0) * 1e3:.1f} ms, units "
            f"{d[0] * 1e3:.1f} / {d[len(d) // 2] * 1e3:.1f} / "
            f"{d[-1] * 1e3:.1f} ms, longest gap {g * 1e3:.1f} ms after unit "
            f"{i}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not cell:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell[0]["chips"]:
        print(f"{args.workload} needs {cell[0]['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.init()
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), marks={"torch": t_torch,
                                               "cuda": time.perf_counter()})
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
