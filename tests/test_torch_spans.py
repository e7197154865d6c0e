"""The port's spans and copy counters (`sep2023_tpu_torch.spans`).

On the CPU: nesting, parents and self time by the union of the children's
intervals; a span closing on an exception; the unit's id on the shard
threads of `parallel._on_mesh` and in an autograd backward; the buffer's
bound; the copy counts (on `meta` tensors, which stand for a device);
one tiny `ScipyObjective` evaluation recording exactly its named spans,
with one `parallel.chunk` a chunk; and the line `invert` prints after each
stage, under scipy and under --optimizer ondevice.

On the card (marker `cuda`, skipped without one): one small gradient
evaluation under a device-only `torch.profiler`, its spans placed on the
profiler's clock (the Unix clock) by one reading of both clocks taken
together: the forward's kernels start after
`cuda_engine.forward` began (the first within 2 ms), the backward's after
`cuda_engine.backward` began, the copies to the host end inside
`optimize.to_host`, and the counters count the trace's copies each way;
and, once an evaluation has run, the head copies nothing to the device in
an evaluation (its mask and reference fields stay there), which copies
one parameter each and one channel index a shot.

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""
import re
import threading
import time

import numpy as np
import pytest
import torch

from sep2023_tpu_torch import (cli, heads, models, optimize, parallel,
                               spans)
from sep2023_tpu_torch.ops import cuda_engine


def _mine(before):
    """The spans recorded since the id `before` was drawn, oldest first."""
    return [s for s in spans.RECORDS if s.id > before]


def _last_id():
    with spans.span("test.mark") as s:
        pass
    return s.id


def test_nesting_parents_and_self_time():
    mark = _last_id()
    with spans.span("test.outer", unit=True) as outer:
        with spans.span("test.a") as a:
            with spans.span("test.inner") as inner:
                pass
        with spans.span("test.b") as b:
            pass
    recs = _mine(mark)
    assert [s.name for s in recs] == ["test.inner", "test.a", "test.b",
                                      "test.outer"]
    assert (a.parent, b.parent, inner.parent) == (outer.id, outer.id, a.id)
    assert outer.parent == 0
    assert {s.unit for s in recs} == {outer.id}
    assert outer.t0 <= a.t0 <= inner.t0 <= inner.t1 <= a.t1 <= b.t0 \
        <= b.t1 <= outer.t1
    own = spans.self_ns(recs)
    assert own[outer.id] == (outer.t1 - outer.t0) - (a.t1 - a.t0) \
        - (b.t1 - b.t0)
    assert own[a.id] == (a.t1 - a.t0) - (inner.t1 - inner.t0)
    assert own[inner.id] == inner.t1 - inner.t0


def _made(name, id_, parent, t0, t1):
    s = spans.span(name)
    s.id, s.parent, s.unit, s.t0, s.t1 = id_, parent, 0, t0, t1
    return s


def test_self_time_is_less_the_union_of_the_children():
    """Children that overlap (shard threads) are taken once; a child's
    part outside its parent is not taken."""
    top = _made("p", 1, 0, 100, 200)
    kids = [_made("c", 2, 1, 110, 150), _made("c", 3, 1, 120, 160),
            _made("c", 4, 1, 170, 180), _made("c", 5, 1, 190, 230),
            _made("g", 6, 2, 115, 125)]
    own = spans.self_ns([top, *kids])
    assert own[1] == 100 - (50 + 10 + 10)
    assert own[2] == 40 - 10 and own[5] == 40


def test_span_closes_on_an_exception():
    mark = _last_id()
    with pytest.raises(ValueError):
        with spans.span("test.unit", unit=True):
            with spans.span("test.raises"):
                raise ValueError("the window closed")
    names = [s.name for s in _mine(mark)]
    assert names == ["test.raises", "test.unit"]
    assert spans._stack() == []
    with spans.span("test.after") as after:
        pass
    assert after.unit == 0 and after.parent == 0


def test_unit_id_on_shard_threads_and_in_the_backward():
    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with spans.span("test.backward"):
                return 2 * g

    mark = _last_id()
    mesh = (torch.device("cpu"),) * 3
    with spans.span("test.evaluate", unit=True) as ev:
        with spans.span("test.loss"):
            def shard(i, dev):
                with spans.span("test.shard") as s:
                    return s.thread
            threads = parallel._on_mesh(mesh, shard)
        x = torch.ones(3, requires_grad=True)
        torch.autograd.grad(Twice.apply(x).sum(), x)
    recs = _mine(mark)
    shards = [s for s in recs if s.name == "test.shard"]
    assert len(shards) == 3 and {s.unit for s in shards} == {ev.id}
    assert all(s.parent == 0 for s in shards)   # no open span on its thread
    assert set(threads) == {s.thread for s in shards}
    assert threading.get_ident() not in threads
    (bwd,) = [s for s in recs if s.name == "test.backward"]
    assert bwd.unit == ev.id
    # a unit inside a unit is no unit of its own
    with spans.span("test.outer", unit=True) as outer:
        with spans.span("test.nested", unit=True) as nested:
            pass
    assert nested.unit == outer.id


def test_buffer_is_bounded():
    n = spans.RECORDS.maxlen
    assert n == 65536
    for _ in range(n + 5):
        with spans.span("test.fill"):
            pass
    assert len(spans.RECORDS) == n
    assert all(s.name == "test.fill" for s in spans.RECORDS)


def test_copy_counters():
    """Counted only for a tensor off the host (meta stands for a device),
    by its own bytes, in the innermost span of the calling thread only."""
    dev = torch.empty((3, 5), dtype=torch.float32, device="meta")
    host = torch.empty((3, 5), dtype=torch.float64)
    with spans.span("test.outer") as outer:
        with spans.span("test.copies") as s:
            assert spans.h2d(dev) is dev
            spans.h2d(host)
            spans.d2h(dev)
            spans.d2h(dev[0])
            t = threading.Thread(target=spans.h2d, args=(dev,))
            t.start()
            t.join()
    assert (s.h2d, s.h2d_bytes, s.d2h, s.d2h_bytes) == (1, 60, 2, 80)
    assert (outer.h2d, outer.d2h) == (0, 0)


def _objective(device, shot_chunk=0, nz=28, nx=48, nt=80, npml=8):
    """A ScipyObjective as `invert` builds it (the kernels' loss, L2 on
    ett, the vp_vs_rho head) at a small size, on `device`."""
    f32 = torch.float32
    cfg, survey, geoms, stf = cli.benchmark_problem(
        nz=nz, nx=nx, nt=nt, npml=npml, device=device, dtype=f32)
    true, init, bounds, names = models.twin_experiment_setup(
        "vp_vs_rho", nz, nx, dtype=f32)
    head = heads.HEADS["vp_vs_rho"](cfg.grid, init,
                                    mask=heads.default_mask(cfg.grid, 4),
                                    bounds=bounds)
    tensors = lambda p: {k: torch.as_tensor(np.asarray(v)).to(device, f32)
                         for k, v in p.items()}
    init_t = tensors(init)
    fwd = parallel.make_forward(cfg, survey, use_kernels=True,
                                shot_chunk=shot_chunk, device=device,
                                dtype=f32)
    obs = fwd(*head.apply(tensors(true)), stf)
    data_loss = cli.build_stage_loss(cfg, survey, geoms, use_kernels=True,
                                     shot_chunk=shot_chunk,
                                     channels=("ett",))
    w = cli.shot_weights(survey, device=device, dtype=f32)

    def loss(params, stf_, obs_):
        return data_loss(*head.apply({**init_t, **params}), stf_, obs_, w)

    return optimize.ScipyObjective(
        loss, {k: np.asarray(init[k]) for k in names},
        bounds={k: bounds[k] for k in names}, aux=(stf, obs), device=device,
        dtype=f32), survey.n_shots


@pytest.mark.parametrize("shot_chunk", [0, 2])
def test_one_evaluation_records_its_spans(shot_chunk):
    obj, n_shots = _objective(torch.device("cpu"), shot_chunk)
    mark = _last_id()
    f, g = obj._evaluate(obj.x0)
    assert np.isfinite(f) and np.isfinite(g).all() and f > 0
    recs = _mine(mark)
    (ev,) = [s for s in recs if s.name == "optimize.evaluate"]
    assert {s.unit for s in recs} == {ev.id}
    chunks = -(-n_shots // shot_chunk) if shot_chunk else 1
    names = sorted(s.name for s in recs)
    assert names == sorted(["optimize.evaluate", "optimize.unpack",
                            "optimize.loss", "heads.apply",
                            "optimize.grad", "optimize.to_host"]
                           + ["parallel.chunk"] * chunks)
    by = {s.name: s for s in recs}
    for name in ("optimize.unpack", "optimize.loss", "optimize.grad",
                 "optimize.to_host"):
        assert by[name].parent == ev.id
    loss = by["optimize.loss"]
    assert by["heads.apply"].parent == loss.id
    assert all(s.parent == loss.id for s in recs
               if s.name == "parallel.chunk")
    # nothing crosses a bus on the CPU
    assert sum(s.h2d + s.d2h for s in recs) == 0
    p = spans.per_evaluation(recs)
    assert p["evaluations"] == 1 and p["scipy"] is None
    assert p["enqueue"] == 0 and p["h2d_kib"] == 0


HOST_LINE = re.compile(
    r"^host per evaluation: (scipy (?P<scipy>[\d.]+) ms, )?unpack "
    r"(?P<unpack>[\d.]+) ms, head (?P<head>[\d.]+) ms, enqueue "
    r"(?P<enqueue>[\d.]+) ms, wait (?P<wait>[\d.]+) ms; copied "
    r"(?P<h2d>[\d.]+) KiB to the device, (?P<d2h>[\d.]+) KiB to the host$",
    re.M)


@pytest.mark.parametrize("optimizer", ["scipy", "ondevice"])
def test_invert_prints_the_host_line_of_each_stage(optimizer, tmp_path,
                                                   capsys):
    argv = ["invert", "--device", "cpu", "--nz", "28", "--nx", "48", "--nt",
            "80", "--npml", "8", "--niter", "2", "--bands",
            "0,2,8,12;0,2,12,18",
            "--optimizer", optimizer, "--exp-name", str(tmp_path / "e")]
    cli.main(argv)
    out = capsys.readouterr().out
    lines = [m.groupdict() for m in HOST_LINE.finditer(out)]
    assert len(lines) == 2 == out.count("stage misfit")
    for m in lines:
        assert (m["scipy"] is not None) == (optimizer == "scipy")
        assert float(m["head"]) > 0 and float(m["wait"]) >= 0
        # the plain versions on the CPU: no kernel call, no copy
        assert float(m["enqueue"]) == 0 and float(m["h2d"]) == 0
    # each stage's line follows its misfit line
    stage = out.splitlines()
    for i, line in enumerate(stage):
        if line.startswith("stage misfit"):
            assert HOST_LINE.match(stage[i + 1])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_on_the_profiler_clock(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    obj, _ = _objective(card, nz=60, nx=100, nt=400)
    obj._evaluate(obj.x0)   # builds the kernels, uploads the plan's tables
    torch.cuda.synchronize()
    mark = _last_id()
    launches = cuda_engine.LAUNCHES
    # one reading of the span clock and of the profiler's, taken together
    anchor = time.perf_counter_ns(), time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        obj._evaluate(obj.x0)
        torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((start + round(e.time_range.start * 1e3),
                     start + round(e.time_range.end * 1e3), e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    recs = _mine(mark)
    (ev,) = [s for s in recs if s.name == "optimize.evaluate"]
    one = {s.name: s for s in recs}
    fwd, bwd = one["cuda_engine.forward"], one["cuda_engine.backward"]
    host = one["optimize.to_host"]
    t = lambda t_ns: t_ns - anchor[0] + anchor[1]

    fk = [e for e in events if "fwd_step_kernel" in e[2]]
    assert len(fk) == cuda_engine.LAUNCHES - launches
    assert min(e[0] for e in fk) >= t(fwd.t0)
    assert fk[0][0] - t(fwd.t0) < 2_000_000, (fk[0][0], t(fwd.t0))
    bk = [e for e in events if "bwd_step_kernel" in e[2]]
    assert bk and min(e[0] for e in bk) >= t(bwd.t0)
    # the backward ran on autograd's device thread, in the evaluation
    assert bwd.unit == ev.id and bwd.thread != ev.thread

    h2d = [e for e in events if "Memcpy HtoD" in e[2]]
    d2h = [e for e in events if "Memcpy DtoH" in e[2]]
    assert len(d2h) == 4      # the loss and the three gradients
    for a, b, _ in d2h:
        assert t(host.t0) <= a and b <= t(host.t1), (a, b, t(host.t0),
                                                     t(host.t1))
    assert len(h2d) == sum(s.h2d for s in recs)
    assert len(d2h) == sum(s.d2h for s in recs)


@pytest.mark.cuda
def test_head_copies_nothing_once_warm(card):
    obj, n_shots = _objective(card, nz=60, nx=100, nt=400)
    obj._evaluate(obj.x0)
    torch.cuda.synchronize()
    mark = _last_id()
    obj._evaluate(obj.x0)
    recs = _mine(mark)
    (head,) = [s for s in recs if s.name == "heads.apply"]
    assert (head.h2d, head.h2d_bytes) == (0, 0)
    assert sum(s.h2d for s in recs) == len(obj.names) + n_shots
