"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes of a unit of work (`work/<kind>.json`, expressions over a
configuration's shapes), the kernels that do each kind of work
(`kernels/<kernel>.json`), and the roofline, whole-step and GCell
arithmetic over them.

A roofline share is the least time the card could take for the work, the
larger of its operations over the FP32 peak and its bytes over the memory
peak, divided by the device time the trace gives the kernels doing it.
"""
from __future__ import annotations

import ast
import json
import operator
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): FP32
# outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv}


def evaluate(expr: str, names: dict) -> int:
    """An integer expression of +, -, *, //, parentheses, whole numbers and
    the given names."""
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name) and node.id in names:
            return int(names[node.id])
        raise ValueError(f"not allowed in a work expression: "
                         f"{ast.dump(node)} in {expr!r}")
    return ev(ast.parse(expr, mode="eval"))


def dims(cfg: dict, shots: int) -> dict:
    """The names a work expression may use, for `shots` shots of a
    configuration: nz, nx (padded), nt, S, R, L (strip depth), strip_len."""
    n = cfg["npml"]
    nz, nx, L = cfg["nz"] + 2 * n, cfg["nx"] + 2 * n, 5
    return {"nz": nz, "nx": nx, "nt": cfg["nt"], "S": shots,
            "R": cfg["n_rec"], "L": L, "strip_len": 2 * L * (nz + nx)}


def cells(cfg: dict, shots: int) -> int:
    """GCell count's numerator: nz nx (nt - 1) shots on the padded grid."""
    d = dims(cfg, shots)
    return d["nz"] * d["nx"] * (d["nt"] - 1) * shots


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def ops_bytes(kind: str, cfg: dict, shots: int) -> tuple[int, int]:
    w = load("work", kind)
    d = dims(cfg, shots)
    return evaluate(w["ops"], d), evaluate(w["bytes"], d)


def bound_s(kind: str, cfg: dict, shots: int) -> float:
    ops, n_bytes = ops_bytes(kind, cfg, shots)
    return max(ops / PEAK_FP32, n_bytes / PEAK_BYTES)


def units_work(traffic: dict, chunks: list[int], n_units: int):
    """[(kind, shots, count)]: the work of n_units evaluations or calls,
    each running the traffic's work_per_chunk once a shot chunk."""
    return [(kind, s, n_units) for s in chunks
            for kind in traffic["work_per_chunk"]]


def roofline_pct(kernel: str, work, cfg: dict, kernel_s: dict):
    """The kernel's share of its roofline in percent over the traced work,
    or None when the trace gave it no time or it did none of the work."""
    spec = load("kernels", kernel)
    t = kernel_s.get(kernel, 0.0)
    bound = sum(bound_s(kind, cfg, s) * n for kind, s, n in work
                if kind in spec["does"])
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t


def mfu_pct(work, cfg: dict, window_s: float):
    """The work's FP32 operations over the window and the FP32 peak, in
    percent."""
    ops = sum(ops_bytes(kind, cfg, s)[0] * n for kind, s, n in work)
    if window_s <= 0 or ops <= 0:
        return None
    return 100.0 * ops / window_s / PEAK_FP32
