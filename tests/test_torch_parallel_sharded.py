"""The port's shot sharding against the JAX package's, on the CPU.

The problem of tests/test_parallel.py (44x52, nt=60, npml 8, 8 shots, 12
receivers, observed data from lam * 1.05) in float64: the port's meshes of
CPU devices, (cpu,) * 8, against `sep2023_tpu.parallel.shot_mesh(8)` over
conftest's eight virtual devices.  Here the checks 1 (the sharded misfit),
2b (the chunked accumulator inside each shard) and 3 (the kernels' sharded
loss, here their plain versions on CPU tensors in float32, with the
plain-call counts exact under threads) of
`__graft_entry__.py::dryrun_multichip`, `pad_shots`, the device-count rule,
a shard's error reaching the caller and one build under concurrent first
use.  Check 2 (the CLI's builder), the ragged survey, `make_forward(mesh=)`
and the 4 x 2 shot x domain mesh are in tests/test_torch_parallel_mesh.py,
which shares this file's problem.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import two_threads  # noqa: F401  (autouse)

import sep2023_tpu as st
from sep2023_tpu import parallel as jpar
from sep2023_tpu.config import Survey as JSurvey
from sep2023_tpu.propagator import propagate_ad
from sep2023_tpu_torch import parallel
from sep2023_tpu_torch.config import SimConfig, Survey
from sep2023_tpu_torch.ops import _build, cuda_engine
from sep2023_tpu_torch.propagator import ShotGeom

NAMES = ("lam", "mu", "rho", "stf")


def _survey(n=8, rec_x=np.arange(8, 32, 2)):
    return dict(src_z=np.full(n, 4), src_x=np.arange(4, 4 + 4 * n, 4),
                rec_z=np.full(len(rec_x), 24), rec_x=rec_x)


@pytest.fixture(scope="module")
def problem():
    """(cfg, numpy arrays (lam, mu, rho, stf, obs, w), port survey) of
    tests/test_parallel.py's problem, the data made by the JAX package."""
    jcfg = st.SimConfig(nz=44, nx=52, dz=20.0, dx=20.0, nt=60, dt=0.002,
                        f0=10.0, npml=8)
    vp = jnp.full(jcfg.grid.shape, 3000.0)
    med = st.Medium(vp, vp / jnp.sqrt(3.0), jnp.full_like(vp, 2500.0))
    survey = JSurvey(**_survey())
    geoms = jpar.survey_to_geoms(survey, jcfg.npml, dtype=jnp.float64)
    stf = jnp.broadcast_to(jnp.asarray(st.ricker(jcfg.f0, jcfg.nt,
                                                 jcfg.dt)), (8, jcfg.nt))
    # compiled: eager op-by-op dispatch of the 60 steps takes seconds
    obs = jax.jit(jax.vmap(lambda s, g: propagate_ad(
        jcfg, med.lam * 1.05, med.mu, med.rho, s, g)))(stf, geoms)
    cfg = SimConfig(nz=44, nx=52, dz=20.0, dx=20.0, nt=60, dt=0.002,
                    f0=10.0, npml=8)
    arrays = tuple(np.asarray(a, np.float64) for a in
                   (med.lam, med.mu, med.rho, stf, obs, jnp.ones(8)))
    return cfg, arrays, Survey(**_survey())


def _jax_vg(loss, args, n_model=3):
    """JAX value and (lam, mu, rho, stf) gradients of loss(*args)."""
    v, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(*args)
    return float(v), [np.asarray(a) for a in g]


def _port_vg(loss, model, rest):
    """The port's value and (lam, mu, rho, stf) gradients of
    loss(*model, *rest), model = (lam, mu, rho, stf)."""
    p = [torch.as_tensor(a).clone().requires_grad_() for a in model]
    v = loss(*p, *rest)
    return float(v.detach()), [g.numpy() for g in torch.autograd.grad(v, p)]


def _close(v, g, v_ref, g_ref, rtol, gtol, where=lambda a: a):
    assert v == pytest.approx(v_ref, rel=rtol)
    for name, a, b in zip(NAMES, g, g_ref):
        a, b = where(a), where(b)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
        assert err < gtol, (name, err)


def _port(arrays, survey, cfg, dtype=torch.float64):
    lam, mu, rho, stf, obs, w = (torch.tensor(a).to(dtype) for a in arrays)
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device="cpu",
                                     dtype=dtype)
    return (lam, mu, rho, stf), geoms, obs, w


@pytest.mark.parametrize("n_dev,chunk", [(8, 0), (2, 2)],
                         ids=["8 shards", "2 shards chunked by 2"])
def test_sharded_misfit_matches_jax_and_local(problem, n_dev, chunk):
    """Checks 1 and 2b: make_sharded_misfit over (cpu,) * n_dev, with
    shot_chunk inside each shard (the accumulator in a thread), against the
    JAX sharded misfit and the port's unsharded local loss."""
    cfg, arrays, survey = problem
    model, geoms, obs, w = _port(arrays, survey, cfg)
    mesh = parallel.shot_mesh(n_dev, device="cpu")
    assert mesh == (torch.device("cpu"),) * n_dev
    v, g = _port_vg(parallel.make_sharded_misfit(cfg, mesh, shot_chunk=chunk),
                    model, (geoms, obs, w))
    v_lo, g_lo = _port_vg(parallel.make_local_misfit(cfg), model,
                          (geoms, obs, w))
    _close(v, g, v_lo, g_lo, 1e-10, 1e-8)

    jcfg = st.SimConfig(**{k: getattr(cfg, k) for k in
                           ("nz", "nx", "dz", "dx", "nt", "dt", "f0",
                            "npml")})
    jgeoms = jpar.survey_to_geoms(JSurvey(**_survey()), cfg.npml,
                                  dtype=jnp.float64)
    lam, mu, rho, stf, jobs, jw = (jnp.asarray(a) for a in arrays)
    v_j, g_j = _jax_vg(jpar.make_sharded_misfit(jcfg, jpar.shot_mesh(n_dev),
                                                shot_chunk=chunk),
                       (lam, mu, rho, stf, jgeoms, jobs, jw))
    _close(v, g, v_j, g_j, 1e-10, 1e-8)


def test_apply_gradient_sharded_matches_jax():
    """api.ElasticPropagator.apply_gradient(n_devices=2) in float64, the 2
    shots over 2 CPU shards (the plain propagator), against the JAX
    package's apply_gradient(n_devices=2) over 2 virtual devices: loss
    1e-10, gradients 1e-8 of each max."""
    from sep2023_tpu import api as japi
    from sep2023_tpu_torch import api

    vp = np.full((16, 22), 3000.0)
    vp[6:10, 8:14] = 3200.0
    kw = dict(nx=22, nz=16, dx=20.0, dz=20.0, nt=40, dt=0.002, nPml=4,
              vp=vp, vs=vp / np.sqrt(3.0), rho=np.full((16, 22), 2500.0))
    sv = dict(src_z=np.array([2, 2]), src_x=np.array([6, 14]),
              rec_z=np.full(10, 11), rec_x=np.arange(1, 11))
    init = {**kw, "vp": np.full_like(vp, 3000.0)}
    prop = api.ElasticPropagator(api.Model(**kw), Survey(**sv),
                                 device="cpu", dtype=torch.float64)
    obs = prop.apply_forward()
    out = prop.apply_gradient(api.Model(**init), obs, n_devices=2)
    jprop = japi.ElasticPropagator(japi.Model(**kw), JSurvey(**sv),
                                   dtype=jnp.float64)
    ref = jprop.apply_gradient(japi.Model(**init), obs, n_devices=2)
    assert out["misfit"] > 0
    assert out["misfit"] == pytest.approx(ref["misfit"], rel=1e-10)
    for k in ("grad_vp", "grad_vs", "grad_rho", "grad_stf"):
        a, b = out[k], ref[k]
        assert a.shape == b.shape and np.abs(b).max() > 0, k
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), k


def test_pad_shots_zero_weight(problem):
    """5 shots padded to 8: replicas of the last shot with weight 0, the
    same arrays as the JAX package's pad_shots and pad_survey, and the
    5-shot loss."""
    cfg, arrays, survey = problem
    (lam, mu, rho, stf), geoms, obs, w = _port(arrays, survey, cfg)
    sl = lambda t: t[:5]
    geoms5 = ShotGeom(*(sl(g) for g in geoms[:5]))
    aux = (torch.arange(5.0)[:, None].expand(5, 12),)
    stf_p, geoms_p, obs_p, w_p, aux_p = parallel.pad_shots(
        sl(stf), geoms5, sl(obs), sl(w), 8, aux)
    assert stf_p.shape[0] == 8 and float(w_p.sum()) == 5.0
    j = jpar.pad_shots(jnp.asarray(arrays[3][:5]),
                       jpar.survey_to_geoms(JSurvey(**_survey(5)), 8,
                                            dtype=jnp.float64),
                       jnp.asarray(arrays[4][:5]), jnp.ones(5), 8,
                       (jnp.asarray(aux[0].numpy()),))
    np.testing.assert_array_equal(stf_p.numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(j[3]))
    np.testing.assert_array_equal(aux_p[0].numpy(), np.asarray(j[4][0]))
    for a, b in zip(geoms_p[:5], j[1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sp = parallel.pad_survey(Survey(**_survey(5)), 8)
    jsp = jpar.pad_survey(JSurvey(**_survey(5)), 8)
    for k in ("src_z", "src_x", "src_rxz", "rec_z", "rec_x"):
        np.testing.assert_array_equal(getattr(sp, k), getattr(jsp, k))
    loss = parallel.make_local_misfit(cfg)
    f5 = float(loss(lam, mu, rho, sl(stf), geoms5, sl(obs), sl(w)))
    fp = float(loss(lam, mu, rho, stf_p, geoms_p, obs_p, w_p))
    assert fp == pytest.approx(f5, rel=1e-12)


def _f32_problem(problem):
    """The problem in float32 on a receiver row the kernels' plans take:
    (cfg, survey, geoms, model, obs, w) as torch tensors, obs from
    lam * 1.03 by the plain propagator.  The wavelet starts early, as in
    tests/test_parallel.py's float32 checks: with the fixture's delay
    little signal reaches the receivers within nt, and float32 gradients
    are rounding noise."""
    cfg, arrays, _ = problem
    survey = Survey(**_survey(rec_x=np.arange(8, 20)))
    lam, mu, rho, _, _, w = (torch.tensor(a).float() for a in arrays)
    stf = torch.tensor(st.ricker(cfg.f0, cfg.nt, cfg.dt, delay_cycles=0.4),
                       dtype=torch.float32).expand(8, cfg.nt).contiguous()
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device="cpu")
    fwd = parallel.make_forward(cfg, survey, use_kernels=False, device="cpu")
    obs = fwd(lam * 1.03, mu, rho, stf)
    return cfg, survey, geoms, (lam, mu, rho, stf), obs, w


def test_cuda_sharded_misfit_plain_versions(problem):
    """Check 3: make_cuda_sharded_misfit on CPU tensors (the kernels' plain
    versions, float32) over (cpu,) * 4 against the unsharded
    make_cuda_misfit and the JAX sharded misfit in float32; PLAIN_CALLS
    counts exactly one forward with strips and one backward a shard,
    although the shards run in threads at once."""
    cfg, survey, geoms, model, obs, w = _f32_problem(problem)
    mesh = parallel.shot_mesh(4, device="cpu")
    loss = parallel.make_cuda_sharded_misfit(cfg, survey, mesh)
    before = dict(cuda_engine.PLAIN_CALLS)
    v, g = _port_vg(loss, model, (obs, w))
    calls = {k: n - before[k] for k, n in cuda_engine.PLAIN_CALLS.items()}
    assert calls == {**{k: 0 for k in calls}, "forward_plain_strips": 4,
                     "backward_plain": 4}
    v_lo, g_lo = _port_vg(parallel.make_cuda_misfit(cfg, survey), model,
                          (obs, w))
    _close(v, g, v_lo, g_lo, 1e-6, 2e-5)

    jcfg = st.SimConfig(nz=44, nx=52, dz=20.0, dx=20.0, nt=60, dt=0.002,
                        f0=10.0, npml=8)
    jgeoms = jpar.survey_to_geoms(
        JSurvey(**_survey(rec_x=np.arange(8, 20))), 8, dtype=jnp.float32)
    f32 = lambda t: jnp.asarray(t.numpy(), jnp.float32)
    v_j, g_j = _jax_vg(jpar.make_sharded_misfit(jcfg, jpar.shot_mesh(4)),
                       (*(f32(t) for t in model), jgeoms, f32(obs), f32(w)))
    _close(v, g, v_j, g_j, 1e-5, 1e-4)


@pytest.mark.parametrize("n_devices,device,count,n_shots,want", [
    (0, "cpu", 0, 8, None), (1, "cpu", 0, 8, None), (3, "cpu", 0, 8, 3),
    (8, "cpu", 0, 5, 5), (0, "cuda", 4, 8, 4), (2, "cuda", 4, 8, 2),
    (6, "cuda", 4, 8, 4), (0, "cuda", 4, 3, 3), (0, "cuda", 1, 8, None)])
def test_shot_mesh_device_count_rule(monkeypatch, n_devices, device, count,
                                     n_shots, want):
    """n = min(n_devices or count, count, n_shots), one device no mesh: the
    JAX CLI's _resolve_mesh, with CUDA's device count, and k CPU shards for
    n_devices = k on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    mesh = parallel.shot_mesh(n_devices, device=device, n_shots=n_shots)
    if want is None:
        assert mesh is None
    else:
        kind = torch.device(device).type
        assert mesh == tuple(torch.device(kind, i) if kind == "cuda"
                             else torch.device("cpu") for i in range(want))


def test_shard_error_reaches_the_caller(problem):
    """A shard that raises makes the sharded call raise, after every shard
    has ended: nothing is caught and run another way."""
    cfg, arrays, survey = problem
    ended = []

    def shard(i, dev):
        time.sleep(0.05 * (3 - i))
        ended.append(i)
        if i == 1:
            raise RuntimeError("shard 1 failed")
        return i

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        parallel._on_mesh(parallel.shot_mesh(3, device="cpu"), shard)
    assert sorted(ended) == [0, 1, 2]
    model, geoms, obs, w = _port(arrays, survey, cfg)
    loss = parallel.make_sharded_misfit(cfg, parallel.shot_mesh(3,
                                                                device="cpu"))
    with pytest.raises(ValueError, match="pad_shots"):
        loss(*model, geoms, obs, w)


def test_library_builds_once_under_concurrent_first_use(monkeypatch):
    """Shard threads that reach the kernels' first use together run one
    build and share the library (_build.load's lock)."""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return "lib.so"

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    libs = parallel._on_mesh(parallel.shot_mesh(4, device="cpu"),
                             lambda i, dev: _build.load())
    assert len(builds) == 1 and all(lib is libs[0] for lib in libs)
