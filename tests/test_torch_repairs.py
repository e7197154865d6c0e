"""Repairs of the port against the JAX package, on the CPU in float64.

* make_local_misfit takes a per-shot misfit_fn and per-shot trace aux,
  chunked with the other per-shot inputs: equal to the JAX package's to
  1e-12, chunked and unchunked.
* InversionLogger's save_every, start_iter, save_mat and loss_history, and
  lbfgsb's options (disp and iprint dropped), as in tests/test_optimize.py.
* invert's per-shot weights: src_weights squared, ones without them.
* auto_shot_chunk(n_devices=D) sizes a chunk by the ceil(S / D) local
  shots.
* The package data of pyproject.toml covers every source the kernel build
  compiles or hashes.
* F7: `rtm --physics elastic`'s illumination has a kernel route,
  cuda_engine.illumination_cuda_plan.  On CPU tensors it runs
  imaging.source_illumination, counted in PLAIN_CALLS, equal to the JAX
  package's source_illumination shot by shot to 1e-12 (float64); on a
  device that is neither the CPU nor CUDA it raises and runs no plain
  version.
"""
import fnmatch
import os
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from sep2023_tpu import imaging as jimaging
from sep2023_tpu import optimize as joptimize
from sep2023_tpu import parallel as jparallel
from sep2023_tpu.config import SimConfig as JSimConfig
from sep2023_tpu.config import Survey as JSurvey
from sep2023_tpu_torch import cli, imaging, optimize, parallel
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.ops import _build, cuda_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _windowed_problem():
    """3 shots on a 36x44 grid, nt=60, a per-trace weight (S, R) as the
    trace aux and a time window."""
    npml = 6
    kw = dict(nz=24 + 2 * npml, nx=32 + 2 * npml, dz=20.0, dx=20.0, nt=60,
              dt=0.002, f0=10.0, npml=npml)
    survey = dict(src_z=np.ones(3, np.int64), src_x=np.array([6, 16, 26]),
                  rec_z=np.full(20, 10), rec_x=np.arange(6, 26))
    rng = np.random.default_rng(3)
    vp = np.full((kw["nz"], kw["nx"]), 3000.0)
    vp[14:20, 16:28] += 200.0
    rho = np.full_like(vp, 2500.0)
    lam, mu = (vp ** 2 - 2 * (vp / np.sqrt(3)) ** 2) * rho, vp ** 2 / 3 * rho
    stf = np.stack([ricker(10.0, kw["nt"], kw["dt"]) * (1 + 0.1 * s)
                    for s in range(3)])
    obs = rng.standard_normal((3, 4, 20, kw["nt"])) * 1e-3
    tw = rng.uniform(0.5, 1.5, (3, 20))
    w = np.array([1.0, 0.5, 2.0])
    window = ((np.arange(kw["nt"]) >= 10)
              & (np.arange(kw["nt"]) < 50)).astype(np.float64)
    return kw, survey, (lam * 1.02, mu, rho, stf), obs, tw, w, window


@pytest.mark.parametrize("chunk", [0, 2], ids=["unchunked", "chunked"])
def test_local_misfit_fn_and_trace_aux_match_jax(chunk):
    """A windowed, per-trace weighted misfit_fn with one per-shot aux array
    through make_local_misfit: value and (lam, mu, rho, stf) gradients equal
    to the JAX package's to 1e-12."""
    kw, sv, (lam, mu, rho, stf), obs, tw, w, window = _windowed_problem()

    def mf_jax(o, s, tw_s):
        r = (o - s)[3] * tw_s[:, None] * jnp.asarray(window)
        return 0.5 * jnp.sum(r * r)

    def mf_torch(o, s, tw_s):
        r = (o - s)[3] * tw_s[:, None] * _f64(window)
        return 0.5 * (r * r).sum()

    jcfg = JSimConfig(**kw)
    jgeoms = jparallel.survey_to_geoms(JSurvey(**sv), kw["npml"],
                                       dtype=jnp.float64)
    jloss = jparallel.make_local_misfit(jcfg, shot_chunk=chunk,
                                        misfit_fn=mf_jax)
    args = [jnp.asarray(a) for a in (lam, mu, rho, stf)]
    val_j, g_j = jax.value_and_grad(
        lambda *m: jloss(*m, jgeoms, jnp.asarray(obs), jnp.asarray(w),
                         jnp.asarray(tw)), argnums=(0, 1, 2, 3))(*args)

    cfg = SimConfig(**kw)
    geoms = parallel.survey_to_geoms(Survey(**sv), kw["npml"], device="cpu",
                                     dtype=torch.float64)
    loss = parallel.make_local_misfit(cfg, shot_chunk=chunk,
                                      misfit_fn=mf_torch)
    ps = [_f64(a).requires_grad_() for a in (lam, mu, rho, stf)]
    val = loss(*ps, geoms, _f64(obs), _f64(w), _f64(tw))
    g = torch.autograd.grad(val, ps)
    val = float(val.detach())
    assert val > 0
    assert val == pytest.approx(float(val_j), rel=1e-12)
    for a, b in zip(g, g_j):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()


def _quad_problem():
    target = {"a": np.array([[1.0, 2.0], [3.0, 4.0]]), "b": np.array([5.0])}

    def loss(p):
        return (((p["a"] - _f64(target["a"])) ** 2).sum()
                + ((p["b"] - 5.0) ** 2).sum())

    return loss, target


def test_lbfgsb_options_unconstrained():
    """tests/test_optimize.py's case: disp and iprint are accepted and
    dropped, the fit converges; another option reaches scipy."""
    loss, target = _quad_problem()
    obj = optimize.ScipyObjective(loss, {"a": np.zeros((2, 2)),
                                         "b": np.zeros(1)},
                                  device="cpu", dtype=torch.float64)
    res = optimize.lbfgsb(obj, maxiter=50, disp=False, iprint=-1)
    out = obj.unpack(res.x)
    assert np.allclose(out["a"].numpy(), target["a"], atol=1e-5)
    assert np.allclose(out["b"].numpy(), 5.0, atol=1e-5)
    capped = optimize.ScipyObjective(loss, {"a": np.zeros((2, 2)),
                                            "b": np.zeros(1)},
                                     device="cpu", dtype=torch.float64)
    res = optimize.lbfgsb(capped, maxiter=50, maxfun=2)
    assert capped.n_evals <= 3 and res.nfev <= 3


def test_lbfgsb_options_bounds():
    loss, _ = _quad_problem()
    obj = optimize.ScipyObjective(loss, {"a": np.zeros((2, 2)),
                                         "b": np.zeros(1)},
                                  bounds={"a": (0.0, 2.5), "b": (0.0, 10.0)},
                                  device="cpu", dtype=torch.float64)
    res = optimize.lbfgsb(obj, maxiter=50, disp=False, iprint=-1)
    a = obj.unpack(res.x)["a"].numpy()
    assert a.max() <= 2.5 + 1e-12
    assert np.allclose(a.ravel()[:2], [1.0, 2.0], atol=1e-5)


def test_inversion_logger_matches_jax(tmp_path):
    """save_every, start_iter, save_mat and loss_history: the same files,
    loss.txt and history as the JAX package's logger on the same fit."""
    loss, _ = _quad_problem()

    def jloss(p):
        return (jnp.sum((p["a"] - jnp.asarray([[1.0, 2.0], [3.0, 4.0]]))
                        ** 2) + jnp.sum((p["b"] - 5.0) ** 2))

    p0 = {"a": np.zeros((2, 2)), "b": np.zeros(1)}
    out = {}
    for name, mod, fn, kw in (("torch", optimize, loss,
                               dict(device="cpu", dtype=torch.float64)),
                              ("jax", joptimize, jloss, {})):
        d = str(tmp_path / name)
        obj = mod.ScipyObjective(fn, p0, **kw)
        log = mod.InversionLogger(d, obj, save_every=2, start_iter=3,
                                  save_mat=True)
        mod.lbfgsb(obj, maxiter=4, callback=log)
        out[name] = (d, log)
    (d_t, log_t), (d_j, log_j) = out["torch"], out["jax"]
    assert len(log_t.loss_history) == len(log_j.loss_history) >= 2
    np.testing.assert_allclose(log_t.loss_history, log_j.loss_history,
                               rtol=1e-12, atol=1e-12)
    assert log_t.it == log_j.it == 3 + len(log_t.loss_history)
    assert sorted(os.listdir(d_t)) == sorted(os.listdir(d_j))
    assert "model_0004.mat" in os.listdir(d_t)
    assert "model_0003.npz" not in os.listdir(d_t)   # 3 % save_every
    hist = np.loadtxt(os.path.join(d_t, "loss.txt"), ndmin=2)
    assert hist[0, 0] == 3
    np.testing.assert_allclose(
        hist, np.loadtxt(os.path.join(d_j, "loss.txt"), ndmin=2),
        rtol=1e-12)
    mat = scipy.io.loadmat(os.path.join(d_t, "model_0004.mat"))
    np.testing.assert_allclose(
        mat["a"], scipy.io.loadmat(os.path.join(d_j, "model_0004.mat"))["a"],
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5]],
                         ids=["none", "src_weights"])
def test_invert_shot_weights_follow_the_reference(weights):
    """`invert` weights a shot's misfit by its src_weight squared (the
    weight multiplies the residual), ones when the survey has none."""
    survey = Survey(src_z=np.ones(3, np.int64), src_x=np.array([4, 8, 12]),
                    rec_z=np.full(5, 6), rec_x=np.arange(2, 7),
                    src_weights=None if weights is None
                    else np.array(weights))
    w = cli.shot_weights(survey, device="cpu", dtype=torch.float64)
    want = (np.ones(3) if weights is None
            else np.asarray(jnp.asarray(weights, jnp.float64) ** 2))
    assert w.dtype == torch.float64 and w.numpy().tolist() == want.tolist()


@pytest.mark.parametrize("n_devices", [1, 2, 3])
def test_auto_shot_chunk_per_device(n_devices):
    """With D devices a chunk is sized by the ceil(S / D) local shots: 0
    when they all fit, else the largest chunk that fits, at most the local
    count (the JAX package's rule, with the port's per-shot bytes)."""
    cfg = SimConfig(nz=165, nx=265, dz=20.0, dx=20.0, nt=1501, dt=0.002,
                    f0=10.0, npml=32)
    per = parallel.strip_bytes_per_shot(cfg) + \
        parallel.state_bytes_per_shot(cfg)
    S = 19
    local = -(-S // n_devices)
    for budget in (local * per, 5 * per + 1, per // 2, 40 * per):
        got = parallel.auto_shot_chunk(cfg, S, budget_bytes=budget,
                                       n_devices=n_devices)
        want = 0 if per * local <= budget else max(1, min(local,
                                                          budget // per))
        assert got == want
    assert parallel.auto_shot_chunk(cfg, S, budget_bytes=7 * per,
                                    n_devices=n_devices) == \
        (0 if local <= 7 else 7)


def test_package_data_covers_the_kernel_sources():
    """pyproject.toml ships csrc/*.cu and *.cuh with sep2023_tpu_torch, so
    that an installed copy can build its kernels: every file ops/_build.py
    compiles or hashes matches those globs."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fp:
        setup = tomllib.load(fp)["tool"]["setuptools"]
    assert any(fnmatch.fnmatch("sep2023_tpu_torch", g)
               for g in setup["packages"]["find"]["include"])
    globs = setup["package-data"]["sep2023_tpu_torch"]
    pkg = _build.CSRC.parent
    files = [*_build._sources(), *_build.CSRC.glob("*.cuh")]
    assert len(files) >= 6
    for f in files:
        rel = f.relative_to(pkg).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


def _illumination_problem():
    """2 shots (source moment ratios 1 and 1.4) on a 46x60 grid (npml 8),
    nt=110, a receiver row, numpy float64: (kw, survey, lam, mu, rho,
    stf)."""
    npml = 8
    kw = dict(nz=30 + 2 * npml, nx=44 + 2 * npml, dz=20.0, dx=20.0, nt=110,
              dt=0.002, f0=10.0, npml=npml)
    rng = np.random.default_rng(9)
    vp = 3000.0 + 40.0 * rng.standard_normal((kw["nz"], kw["nx"]))
    vp[npml + 16:npml + 22, npml + 14:npml + 30] += 300.0
    vs = vp / np.sqrt(2.2)
    rho = 2400.0 + 10.0 * rng.standard_normal(vp.shape)
    survey = dict(src_z=np.array([2, 2]), src_x=np.array([10, 30]),
                  rec_z=np.full(28, 14), rec_x=np.arange(8, 36),
                  src_rxz=np.array([1.0, 1.4]))
    stf = np.stack([ricker(10.0, 110, 0.002), 0.5 * ricker(12.0, 110, 0.002)])
    return (kw, survey, (vp ** 2 - 2 * vs ** 2) * rho, vs ** 2 * rho, rho,
            stf)


def test_illumination_cuda_plan_matches_jax_on_cpu():
    """illumination_cuda_plan on CPU tensors (float64): one PLAIN_CALLS
    entry, no launch, and each shot's plane equal to the JAX package's
    imaging.source_illumination to 1e-12 of its max."""
    kw, sv, lam, mu, rho, stf = _illumination_problem()
    cfg, npml = SimConfig(**kw), kw["npml"]
    plan = cuda_engine.plan_fast_path(cfg, sv["rec_z"] + npml,
                                      sv["rec_x"] + npml)
    before = (cuda_engine.PLAIN_CALLS["source_illumination"],
              cuda_engine.LAUNCHES_ILL)
    # the moment ratios as a Survey holds them (float32), as `rtm` passes
    # them and as the JAX package's geometry has them
    ill = cuda_engine.illumination_cuda_plan(
        plan, *(_f64(a) for a in (lam, mu, rho, stf)), sv["src_z"] + npml,
        sv["src_x"] + npml, Survey(**sv).src_rxz)
    assert (cuda_engine.PLAIN_CALLS["source_illumination"],
            cuda_engine.LAUNCHES_ILL) == (before[0] + 1, before[1])
    assert ill.dtype == torch.float64 and ill.shape == (2, cfg.nz, cfg.nx)
    jgeoms = jparallel.survey_to_geoms(JSurvey(**sv), npml,
                                       dtype=jnp.float64)
    for i in range(2):
        g = type(jgeoms)(*(None if a is None else a[i] for a in jgeoms))
        ref = np.asarray(jimaging.source_illumination(
            JSimConfig(**kw), jnp.asarray(lam), jnp.asarray(mu),
            jnp.asarray(rho), jnp.asarray(stf[i]), g))
        assert ref.max() > 0
        err = np.abs(ill[i].numpy() - ref).max() / ref.max()
        assert err < 1e-12, (i, err)


@pytest.mark.parametrize("library", ["build fails", "built"])
def test_illumination_cuda_plan_raises_off_cpu_and_cuda(monkeypatch,
                                                        library):
    """On a device that is neither the CPU nor CUDA (meta)
    illumination_cuda_plan reaches the kernel library and raises: the
    build's failure, or, with a library in hand, the device check; it runs
    no plain version and counts no launch."""
    def broken_build():
        raise RuntimeError("nvcc failed (simulated)")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA entry point ran a plain version")

    monkeypatch.setattr(_build, "_LIB", None)
    if library == "build fails":
        monkeypatch.setattr(_build, "build", broken_build)
        exc, match = RuntimeError, "simulated"
    else:
        monkeypatch.setattr(_build, "load", lambda: object())
        exc, match = ValueError, "CPU or CUDA tensors"
    monkeypatch.setattr(imaging, "source_illumination", no_plain)
    kw, sv, *_ = _illumination_problem()
    cfg, npml = SimConfig(**kw), kw["npml"]
    plan = cuda_engine.plan_fast_path(cfg, sv["rec_z"] + npml,
                                      sv["rec_x"] + npml)
    meta = lambda *s_: torch.zeros(s_, device="meta")
    before = cuda_engine.LAUNCHES_ILL
    with pytest.raises(exc, match=match):
        cuda_engine.illumination_cuda_plan(
            plan, meta(cfg.nz, cfg.nx), meta(cfg.nz, cfg.nx),
            meta(cfg.nz, cfg.nx), meta(2, cfg.nt), sv["src_z"] + npml,
            sv["src_x"] + npml, sv["src_rxz"])
    assert cuda_engine.LAUNCHES_ILL == before
