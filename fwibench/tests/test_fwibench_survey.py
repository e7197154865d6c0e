"""The configuration's own line survey reaches the port: at main001 and
main004 `drive.build` hands the port what `cli.benchmark_problem` lays out
(the same `Survey` arrays, `ShotGeom` tensors and wavelets, dtype and
device included); a tiny configuration laid out otherwise, with a ragged
shot chunk, runs correct in invert and forward on the CPU under the
committed main001 limits."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from fwibench.harness import drive
from fwibench.harness import work as wk
from fwibench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.device == b.device
                and a.shape == b.shape and torch.equal(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["main001", "main004"])
def test_build_hands_the_port_the_published_survey(name):
    from sep2023_tpu_torch import cli
    from sep2023_tpu_torch.ops import signal as sg

    cj = wk.load("configs", name)
    fields = np.zeros((len(cj["params"]), cj["nz"], cj["nx"]))
    p = drive.build(cj, wk.load("traffic", "invert"), fields, CPU)
    cfg, survey, geoms, stf = cli.benchmark_problem(
        nz=cj["nz"], nx=cj["nx"], dz=cj["dz"], dx=cj["dx"], nt=cj["nt"],
        dt=cj["dt"], f0=cj["f0"], npml=cj["npml"], wavelet=cj["wavelet"],
        device=CPU, dtype=torch.float32)
    assert p.survey.n_shots == cj["n_shots"] and p.survey.n_rec == cj["n_rec"]
    for f in dataclasses.fields(survey):
        assert same(getattr(p.survey, f.name), getattr(survey, f.name)), \
            f.name
    assert p.geoms._fields == geoms._fields
    for k in geoms._fields:
        assert same(getattr(p.geoms, k), getattr(geoms, k)), k
    taper = sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=CPU,
                            dtype=torch.float32)
    assert same(p.stf, (stf * taper).contiguous())
    assert dataclasses.asdict(p.cfg) == dataclasses.asdict(cfg)


def off_layout() -> dict:
    """main001 at 28x48 (npml 8), 3 shots at z=2 from x=7 every 13 and 36
    receivers on row 15 from x=4: not `cli.benchmark_problem`'s layout
    (3 shots at z=1 from x=10, 28 receivers on row 22 from x=10)."""
    cj = tiny.config("main001")
    cj.update(n_shots=3, src_z=2, src_x0=7, src_dx=13, n_rec=36, rec_z=15,
              rec_x0=4)
    return cj


def test_the_off_layout_reaches_the_port():
    cj = off_layout()
    fields = np.zeros((3, cj["nz"], cj["nx"]))
    p = drive.build(cj, {**wk.load("traffic", "invert"), "shot_chunk": 2},
                    fields, CPU)
    assert p.survey.src_z.tolist() == [2, 2, 2]
    assert p.survey.src_x.tolist() == [7, 20, 33]
    assert p.survey.rec_z.tolist() == [15] * 36
    assert p.survey.rec_x.tolist() == list(range(4, 40))
    n = cj["npml"]
    assert p.geoms.rec_x.shape == (3, 36)
    assert p.geoms.src_x.tolist() == [7 + n, 20 + n, 33 + n]
    assert p.stf.shape == (3, cj["nt"])
    assert p.chunks == [2, 1]


@pytest.mark.parametrize("cell,chunks", [("main001-invert", "2x1"),
                                         ("main001-forward", "3")])
def test_off_layout_runs_correct(cell, chunks, monkeypatch, capsys):
    load = wk.load

    def ragged(kind, name):
        out = load(kind, name)
        if (kind, name) == ("traffic", "invert"):
            out["shot_chunk"] = 2
        return out

    monkeypatch.setattr(wk, "load", ragged)
    res = tiny.bench_run.run_cell(tiny.BENCH, cell, 2 ** 31 + 4051, 1.0,
                                  False, device="cpu",
                                  t_start=time.perf_counter(),
                                  config=off_layout())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert f"shot chunk {chunks}," in capsys.readouterr().err


def test_ragged_chunks_do_the_whole_surveys_work():
    cj = off_layout()
    traffic = wk.load("traffic", "invert")
    whole = wk.units_work(traffic, [3], 2)
    ragged = wk.units_work(traffic, [2, 1], 2)
    assert [(k, s) for k, s, _ in ragged] == [
        ("forward_strips", 2), ("adjoint", 2), ("shot_sum", 2),
        ("forward_strips", 1), ("adjoint", 1), ("shot_sum", 1)]
    ops = lambda work: sum(wk.ops_bytes(k, cj, s)[0] * n for k, s, n in work)
    assert ops(ragged) == ops(whole)
    assert wk.mfu_pct(ragged, cj, 1.0) == pytest.approx(
        wk.mfu_pct(whole, cj, 1.0), rel=1e-12)
