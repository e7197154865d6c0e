"""The control of a cell's correctness check: the plain reference put in
the port's place and computed in the precision below the one the
configuration states (bfloat16 for float32), judged by the same numbers
against the reference in the stated precision.  It has to come out as not
correct.  The benchmark's runs never run it.

    python3 fwibench/control.py --workload <cell> --seeds 1 2 3 \
        [--dtype bfloat16] [--device cuda]

invert cells answer at the start model, the point of a window's first
evaluation (loss_gap, grad_gap); forward cells answer with the true
model's data (data_gap).  Prints one JSON line a seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from fwibench import inputs  # noqa: E402
from fwibench.harness import judge  # noqa: E402
from fwibench.harness import work as wk  # noqa: E402
from fwibench.reference import twin  # noqa: E402


def control_numbers(cj: dict, kind: str, seed: int, device, dtype) -> dict:
    """The compared numbers of the reference in `dtype` standing in for
    the port, on seed `seed`."""
    dev = torch.device(device)
    fields, noise = inputs.draw(cj, seed, dev)
    low = twin.Twin(cj, judge.config_module(cj["name"]), dev, dtype)
    low.set_fields(fields)
    if kind == "forward":
        data = low.forward(*low.true_lame()).float().cpu()
        del low
        return judge.reference_forward(cj, fields, [data], device=dev)
    x0 = low.x0()
    f, g = low.value_and_grad(x0, low.observed(noise))
    del low
    out = judge.reference_invert(cj, fields, noise, [(x0, f, g)], x0,
                                 device=dev)
    out.pop("x0_gap")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cj = wk.load("configs", cell["config"])
    kind = wk.load("traffic", cell["traffic"])["kind"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cj, kind, seed, args.device,
                               getattr(torch, args.dtype))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "numbers": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
