"""bench_torch.py, the port's benchmark (`python -m sep2023_tpu_torch
bench`), on the CPU.

* Its problems equal bench.py's, loaded by path under the tests' CPU JAX:
  `_build()` (the reference workload: config, survey, geoms, wavelets and
  lam, mu, rho) and `chunked_problem` in both of its branches, bit for bit.
* Each section's timed function runs at a small shape on CPU tensors, where
  the kernel route takes its plain versions (as `--engine pallas --device
  cpu` does), launches nothing, and returns its keys with finite positive
  values.
* The gradient sections' function (`make_cuda_misfit`'s value and
  gradients, unchunked and chunked) and the acoustic section's equal the
  JAX package's same composition, its Pallas kernels in interpret mode, on
  the same seeded float32 inputs: the loss within LOSS_TOL, each gradient
  within GRAD_TOL of its max on the interior shrunk by GRAD_MARGIN cells
  (the float32 Pallas-vs-plain bounds of the port's kernel tests).
* A section's launch check passes a call on the card that adds exactly its
  launches and runs no plain version, and raises otherwise.
* The section runner prints the flagship's line first and the whole line
  after every section; a failing section raises with the lines printed so
  far left standing; a spent budget lists the remaining sections as
  skipped.
* `bench` without a card exits non-zero, names the card and prints no
  JSON line.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sep2023_tpu import parallel as jpar
from sep2023_tpu.cli import benchmark_problem as jax_benchmark_problem
from sep2023_tpu.ops import pallas_engine as pe
from sep2023_tpu_torch import cli
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.testing import GRAD_MARGIN, GRAD_TOL

REPO = Path(__file__).resolve().parents[1]
# float32 losses of the port's plain versions against the Pallas kernels in
# interpret mode, relative (7e-7 measured at these shapes)
LOSS_TOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(name[:-3], REPO / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bt = _load("bench_torch.py")
jb = _load("bench.py")


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_cfg(t, j):
    assert vars(t) == vars(j)


def _same_survey(t, j):
    for k in ("src_z", "src_x", "rec_z", "rec_x", "src_rxz"):
        _eq(getattr(t, k), getattr(j, k))


def test_build_matches_bench_py():
    ref = bt._build("cpu")
    _, cfg, survey, geoms, stf, med = jb._build()
    _same_cfg(ref.cfg, cfg)
    _same_survey(ref.survey, survey)
    for a, b in zip(ref.geoms, geoms):
        if b is None:
            assert a is None
        else:
            _eq(a.numpy(), b)
    assert ref.stf.dtype == torch.float32 and ref.stf.is_contiguous()
    _eq(ref.stf.numpy(), stf)
    for a, b in zip((*ref.med, *ref.lame), (*med, med.lam, med.mu, med.rho)):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        _eq(a.numpy(), b)
    assert ref.cells == 165 * 265 * 1500 * 19
    assert ref.plan.rs == cuda_engine.RowSurvey(rec_row=127, rec_x0=42,
                                                n_rec=181)


@pytest.mark.parametrize("nx", [128, 96], ids=["nx>120", "nx<=120"])
def test_chunked_problem_matches_bench_py(nx):
    t = bt.chunked_problem(72, nx, 40, n_shots=3, device="cpu")
    j = jb.chunked_problem(72, nx, 40, n_shots=3)
    _same_cfg(t[0], j[0])
    _same_survey(t[1], j[1])
    for a, b in zip((*t[2], *t[2].to_lame()), (*j[2], *j[2].to_lame())):
        _eq(a.numpy(), b)
    for a, b in zip(t[3:], j[3:]):
        assert a.dtype == torch.float32
        _eq(a.numpy(), b)
    assert bt.chunked_problem.__defaults__ == jb.chunked_problem.__defaults__


def test_the_sections_keep_bench_py_workloads():
    """The arguments bench.py passes are the defaults of the port's
    problems and sections."""
    cfg, survey, *_ = bt.rock_problem(device="cpu")
    assert (cfg.nz, cfg.nx, cfg.nt, cfg.dt, cfg.f0) == (265, 385, 4001,
                                                        0.001, 15.0)
    assert survey.n_rec == 301 and survey.rec_z[0] == 190
    p = bt.stream_problem(814, 2064, 601, device="meta")
    assert p.plan.rs == cuda_engine.RowSurvey(770, 42, 1980)
    assert (p.src[0].tolist(), p.src[1].tolist()) == ([33], [1032])
    assert bt.sec_rock_gradient.__defaults__ == (3,)
    assert bt.sec_chunked_gradient.__defaults__ == (4, 2)
    assert bt.sec_acoustic.__defaults__ == (3,)
    assert bt.stream_gcell.__defaults__ == (2,)
    assert bt._time.__kwdefaults__ == {"repeats": 3}
    assert bt._time_pipelined.__kwdefaults__ == {"repeats": 2, "depth": 5}
    names = [n for n, _ in bt.sections(None, None, "cpu")]
    assert names == ["gradient", "814x2064", "rock_gradient",
                     "chunked_gradient", "560x720", "acoustic_gradient",
                     "plain_forward", "814x2064_nt1001"]


@pytest.fixture(scope="module")
def small():
    """The reference workload's problem at 24x40 (+ npml 32), nt=30, and
    its flagship section's output."""
    ref = bt._build("cpu", nz=24, nx=40, nt=30)
    gcell, extra, data = bt.sec_flagship(ref)
    return ref, gcell, extra, data


def _positive(out, keys):
    assert sorted(out) == sorted(keys)
    for k in keys:
        assert np.isfinite(out[k]) and out[k] > 0, k


def _section(name, small):
    ref, _, _, data = small
    if name == "gradient":
        return bt.sec_gradient(ref, data), ["gradient_s",
                                            "gradient_GCell_per_s"]
    if name == "streamed":
        return (bt.sec_streamed(80, 128, 30, "80x128", device="cpu"),
                ["gradient_80x128_GCell_per_s",
                 "forward_80x128_GCell_per_s"])
    if name == "rock_gradient":
        # one shot, its receivers in its own row, at a small grid
        cfg, survey, med, stf, obs, w = bt.chunked_problem(
            72, 128, 40, n_shots=1, device="cpu")
        prob = (cfg, survey, *med.to_lame(), stf, obs, w)
        return bt.sec_rock_gradient(prob), ["rock_gradient_s_72x128x40",
                                            "rock_gradient_GCell_per_s"]
    if name == "chunked_gradient":
        prob = bt.chunked_problem(72, 128, 30, n_shots=3, device="cpu")
        return (bt.sec_chunked_gradient(prob, shot_chunk=2),
                ["chunked_gradient_GCell_per_s_3shot_chunk2"])
    if name == "acoustic_gradient":
        return bt.sec_acoustic(ref), ["acoustic_gradient_GCell_per_s"]
    return bt.sec_plain_forward(ref), ["plain_forward_s",
                                       "plain_forward_GCell_per_s"]


def test_flagship_on_cpu(small):
    ref, gcell, extra, data = small
    assert np.isfinite(gcell) and gcell > 0
    _positive(extra, ["forward_s", "forward_single_dispatch_s",
                      "single_dispatch_GCell_per_s"])
    assert data.shape == (ref.survey.n_shots, 4, ref.survey.n_rec, 30)
    assert torch.isfinite(data).all() and data.abs().max() > 0


@pytest.mark.parametrize("name", ["gradient", "streamed", "rock_gradient",
                                  "chunked_gradient", "acoustic_gradient",
                                  "plain_forward"])
def test_section_on_cpu(name, small):
    """Each section on CPU tensors: its keys, finite and positive; no
    kernel launch, and the plain versions ran."""
    launches0, plain0 = bt._counts()
    out, keys = _section(name, small)
    launches1, plain1 = bt._counts()
    _positive(out, keys)
    assert launches1 == launches0
    assert sum(plain1.values()) > sum(plain0.values())


def _seeded(shape, seed, base, spread):
    rng = np.random.default_rng(seed)
    return (base + spread * rng.standard_normal(shape)).astype(np.float32)


def _interior(cfg, a):
    m = cfg.npml + GRAD_MARGIN
    return np.asarray(a)[m:cfg.nz - m, m:cfg.nx - m]


def _assert_close(cfg, val, grads, val_ref, grads_ref):
    assert abs(float(val) - float(val_ref)) <= LOSS_TOL * abs(float(val_ref))
    for g, r in zip(grads, grads_ref):
        g, r = _interior(cfg, g), _interior(cfg, r)
        assert np.abs(r).max() > 0
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max()


def _elastic_inputs(cfg, S, nt):
    """Seeded float32 (lam, mu, rho, stf, obs, w): a rough model around
    3000 m/s, obs the plain forward of lam raised by 3%."""
    shape = (cfg.nz, cfg.nx)
    vp = _seeded(shape, 1, 3000.0, 40.0)
    rho = _seeded(shape, 2, 2400.0, 20.0)
    vs = vp / np.float32(np.sqrt(3.0))
    lam, mu = (vp ** 2 - 2 * vs ** 2) * rho, vs ** 2 * rho
    stf = _seeded((S, nt), 3, 0.0, 1.0) * np.float32(1e6)
    return lam, mu, rho, stf


@pytest.mark.parametrize("shot_chunk", [0, 2], ids=["unchunked", "chunk2"])
def test_gradient_function_matches_jax(shot_chunk):
    """bench_torch's gradient function (sec_gradient, sec_rock_gradient;
    chunked: sec_chunked_gradient) against make_pallas_misfit under
    jax.value_and_grad in (lam, mu, rho), float32."""
    nz, nx, nt, npml = 24, 40, 150, 8
    cfg, survey, _, _ = cli.benchmark_problem(nz=nz, nx=nx, nt=nt,
                                              npml=npml, device="cpu")
    jcfg, jsurvey, _, _ = jax_benchmark_problem(nz=nz, nx=nx, nt=nt,
                                                npml=npml)
    lam, mu, rho, stf = _elastic_inputs(cfg, survey.n_shots, nt)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    n = cfg.npml
    plan = cuda_engine.plan_for(cfg, cuda_engine.check_row_survey(
        survey.rec_z + n, survey.rec_x + n))
    obs = cuda_engine.forward_cuda_plan(plan, t(lam * np.float32(1.03)),
                                        t(mu), t(rho), t(stf),
                                        survey.src_z + n, survey.src_x + n,
                                        survey.src_rxz)
    w = np.ones(survey.n_shots, np.float32)
    val, *grads = bt.misfit_value_and_grad(cfg, survey, shot_chunk)(
        t(lam), t(mu), t(rho), t(stf), obs, t(w))
    loss_j = jpar.make_pallas_misfit(jcfg, jsurvey, shot_chunk=shot_chunk)
    val_j, grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (lam, mu, rho, stf, obs.numpy(), w)))
    _assert_close(cfg, val, [g.numpy() for g in grads], val_j, grads_j)


def test_acoustic_function_matches_jax():
    """bench_torch's acoustic function (sec_acoustic) against bench.py's
    ac_loss, propagate_pallas_acoustic under jax.value_and_grad in (lam,
    rho), float32, on seeded inputs."""
    ref = bt._build("cpu", nz=24, nx=40, nt=150, npml=8)
    cfg, survey = ref.cfg, ref.survey
    shape = (cfg.nz, cfg.nx)
    rho = _seeded(shape, 2, 2400.0, 20.0)
    lam = rho * _seeded(shape, 1, 2000.0, 30.0) ** 2
    stf = ref.stf.numpy()
    val, *grads = bt.acoustic_value_and_grad(ref)(
        torch.from_numpy(lam), torch.from_numpy(rho), ref.stf)
    sz, sx, _ = ref.src
    rs = pe.check_row_survey(survey.rec_z + cfg.npml,
                             survey.rec_x + cfg.npml)
    jcfg = jax_benchmark_problem(nz=24, nx=40, nt=150, npml=8)[0]

    def ac_loss(l, r, s):
        d = pe.propagate_pallas_acoustic(jcfg, rs, l, r, s, jnp.asarray(sz),
                                         jnp.asarray(sx))
        return 0.5 * jnp.sum(d * d)

    val_j, grads_j = jax.value_and_grad(ac_loss, argnums=(0, 1))(
        jnp.asarray(lam), jnp.asarray(rho), jnp.asarray(stf))
    _assert_close(cfg, val, [g.numpy() for g in grads], val_j, grads_j)


class _OnCard:
    """A stand-in argument that lies on the card, for the launch check."""
    device = torch.device("cuda")


@pytest.mark.parametrize("case", ["exact", "short", "extra_counter",
                                  "plain", "plain_forward"])
def test_launch_check(case, monkeypatch):
    """bt._checked on the card: each call must add exactly per_call to the
    launch counters and run no plain version but the one named."""
    monkeypatch.setattr(cuda_engine, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_engine, "LAUNCHES_BWD", 0)
    monkeypatch.setattr(cuda_engine, "PLAIN_CALLS",
                        dict.fromkeys(cuda_engine.PLAIN_CALLS, 0))
    nt = 7
    plain_forward = case == "plain_forward"

    def fn(_):
        if plain_forward or case == "plain":
            cuda_engine.PLAIN_CALLS["propagate"] += 1
        if not plain_forward:
            cuda_engine.LAUNCHES += nt - (case == "short")
        cuda_engine.LAUNCHES_BWD += case == "extra_counter"

    per_call = {} if plain_forward else {"LAUNCHES": nt}
    plain = "propagate" if plain_forward else None
    if case in ("exact", "plain_forward"):
        t, _ = bt._checked(case, bt._time, fn, (_OnCard(),), per_call,
                           plain=plain)
        assert t >= 0
    else:
        match = "plain calls" if case == "plain" else "launch counters"
        with pytest.raises(RuntimeError, match=match):
            bt._checked(case, bt._time, fn, (_OnCard(),), per_call,
                        plain=plain)


def _result():
    return {"metric": bt.METRIC, "value": 1.5, "unit": "GCell/s",
            "vs_baseline": 1.5, "extra": {"forward_s": 0.1, "skipped": []}}


def _lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_failing_section_raises_after_the_flagship_line(capsys):
    def boom():
        raise ValueError("section failed")

    sections = [("a", lambda: {"a_s": 1.0}), ("b", boom),
                ("c", lambda: {"c_s": 1.0})]
    with pytest.raises(ValueError, match="section failed"):
        bt.run_sections(_result(), sections, budget_s=1e9,
                        start=bt.time.monotonic())
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 2
    assert lines[0]["extra"] == {"forward_s": 0.1, "skipped": []}
    assert lines[1]["extra"]["a_s"] == 1.0 and "c_s" not in lines[1]["extra"]
    assert lines[1]["extra"]["skipped"] == []


def test_spent_budget_skips_the_rest(capsys):
    ran = []
    sections = [(n, lambda n=n: ran.append(n) or {f"{n}_s": 2.0})
                for n in ("a", "b", "c")]
    start = bt.time.monotonic()
    result = bt.run_sections(_result(), sections[:1], budget_s=1e9,
                             start=start)
    result = bt.run_sections(result, sections[1:], budget_s=-1.0,
                             start=start)
    assert ran == ["a"]
    assert result["extra"]["skipped"] == ["b: budget", "c: budget"]
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 5          # flagship, a; flagship again, b, c
    for line in lines:
        assert set(line) == {"metric", "value", "unit", "vs_baseline",
                             "extra"}
        assert line["metric"] == bt.METRIC and line["value"] == 1.5
    assert lines[-1]["extra"]["a_s"] == 2.0
    assert lines[-1]["extra"]["skipped"] == ["b: budget", "c: budget"]


def test_bench_without_a_card_prints_no_line():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "-m", "sep2023_tpu_torch",
                          "bench"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA device" in res.stderr
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
