"""The readers of the port's own spans and copy counters
(`harness/program.py`, the metrics whose source is `program_span` or
`program_counter` and that read them): a traced run of each invert cell on
the CPU at the tiny size reports each of them but the kernel library's
enqueue time, each a finite number; the forward cell reports none of them
there; a checkout of the port from before its span module (the parent of
a traced run's comparison) leaves them all out; and any other fault of
the import fails the run."""
import math
import sys
import types

import pytest
import torch

from fwibench.harness import program
from fwibench.tests import tiny
from fwibench.tests.tiny import bench_run  # fwibench/run.py

NEW = {"scipy_ms.grad", "evaluate_ms_p90.grad", "loss_ms.grad",
       "unpack_ms.grad", "head_ms.grad", "enqueue_ms.grad", "wait_ms.grad",
       "h2d_kib_per_eval.grad", "d2h_kib_per_eval.grad", "enqueue_ms.fwd",
       "chunk_ms.grad", "autograd_ms.grad"}
INVERT = [w["name"] for w in tiny.BENCH["workloads"]
          if w["traffic"] == "invert"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_new_metrics_are_declared():
    per_layer = {m["name"]: m for m in tiny.BENCH["per_layer"]}
    assert NEW <= set(per_layer)
    for name in NEW:
        m = per_layer[name]
        assert m["source"] in ("program_span", "program_counter")
        cells = INVERT if name.endswith(".grad") else ["main001-forward"]
        assert m["workloads"] == cells


@pytest.mark.parametrize("cell", INVERT)
def test_traced_invert_run_reports_the_program_metrics(cell):
    res = tiny.run(cell, seconds=1.5, trace=True)
    assert res["correct"], res["checks"]
    got = {k: v for k, v in res["metrics"].items() if k in NEW}
    # no kernel library is called on the CPU
    assert set(got) == {n for n in NEW if n.endswith(".grad")} \
        - {"enqueue_ms.grad"}
    for name, m in got.items():
        assert math.isfinite(m["value"]) and m["value"] >= 0, name
    assert got["evaluate_ms_p90.grad"]["samples"] == res["attempted"]
    assert got["loss_ms.grad"]["value"] > 0
    # the port's spans lie inside the benchmark's own around the same calls
    old = res["metrics"]
    assert got["evaluate_ms_p90.grad"]["value"] <= \
        old["eval_ms_p90.grad"]["value"]
    assert got["scipy_ms.grad"]["value"] <= \
        old["opt_host_ms.grad"]["value"] + 0.1


def test_forward_cell_reports_none_on_the_cpu():
    res = tiny.run("main001-forward", seconds=0.5, trace=True)
    assert res["correct"] and not set(res["metrics"]) & NEW


def test_a_port_without_spans_leaves_them_out(monkeypatch):
    import sep2023_tpu_torch
    monkeypatch.delattr(sep2023_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "sep2023_tpu_torch.spans", None)
    assert program.records() is None
    for name in NEW:
        assert bench_run.metric_reader(name)(_Run()) is None


def test_a_broken_span_module_fails_the_run(monkeypatch):
    import importlib

    def broken(name, *a, **k):
        if name == program.SPANS:
            raise ModuleNotFoundError("No module named 'numpyy'",
                                      name="numpyy")
        return real(name, *a, **k)

    real = importlib.import_module
    monkeypatch.setattr(program.importlib, "import_module", broken)
    with pytest.raises(ModuleNotFoundError):
        program.records()


def _span(name, t0, t1, parent=0):
    return types.SimpleNamespace(name=name, t0=int(t0 * 1e9),
                                 t1=int(t1 * 1e9), id=id(name) + t0,
                                 parent=parent)


@pytest.mark.parametrize("chunked,ms", [(False, 60.0), (True, 60.0)])
def test_the_adjoint_is_taken_only_from_inside_autograds_call(
        chunked, ms, monkeypatch):
    """`autograd_ms.grad` at one chunk (the adjoint inside the call into
    autograd) and at two (the first chunk's adjoint inside the loss, where
    `_ChunkedSum` takes each chunk's gradient): never the loss's own."""
    recs = [_span("optimize.evaluate", 1.0, 1.95),
            _span("optimize.loss", 1.1, 1.7),
            _span("optimize.grad", 1.75, 1.9),
            _span("cuda_engine.backward", 1.76, 1.85)]
    if chunked:
        recs.append(_span("cuda_engine.backward", 1.2, 1.4))
    monkeypatch.setattr(program, "records", lambda: recs)
    got = bench_run.metric_reader("autograd_ms.grad")(_Run())
    assert got == pytest.approx(ms)


class _Window:
    units = [type("U", (), {"t0": 1.0, "t1": 2.0})()]
    t0, t1, paused_s = 1.0, 2.0, 0.0


class _Run:
    window = _Window()
