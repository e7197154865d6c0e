"""The port's data conditioning and misfits against the JAX package's, on the
CPU, float64.

* ops.signal: bandpass_amplitude, bandpass, apply_bandpass_amplitude,
  per-trace taper windows, source_update_filter and apply_source_filter
  equal sep2023_tpu.ops.signal's to 1e-12, with their gradients.
* ops.misfit: trace_normalize, normalized_crosscorr_misfit and
  make_preprocessed_l2 over its options (window, filter, per-trace,
  dynamic band-pass, l2 and xcorr), value and gradient; the dynamic
  band-pass equals the static one (tests/test_signal.py's
  test_dynamic_bandpass_matches_static); the batched form on a chunk
  equals the per-shot form shot by shot.
* parallel.make_local_misfit with a conditioned misfit and its trace_aux,
  in one chunk and in chunks of 2 over 3 shots, equals the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sep2023_tpu import parallel as jpar
from sep2023_tpu import propagator as jprop
from sep2023_tpu.ops import misfit as jmf
from sep2023_tpu.ops import signal as jsg
from sep2023_tpu_torch import parallel
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.ops import misfit as tmf
from sep2023_tpu_torch.ops import signal as tsg

F64 = torch.float64
NT, DT = 120, 0.002


def _f64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(a, b, what, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), what


def _data(seed, shape=(4, 7, NT)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


@pytest.mark.parametrize("nt,corners", [
    (120, (0.0, 1e-4, 2.0, 4.5)), (121, (3.0, 8.0, 20.0, 40.0)),
    (1000, (1.0, 3.0, 20.0, 40.0))])
def test_bandpass_amplitude_matches_jax(nt, corners):
    ref = np.asarray(jsg.bandpass_amplitude(nt, DT, *corners))
    out = tsg.bandpass_amplitude(nt, DT, *corners).numpy()
    assert out.dtype == np.float64 and out.shape == (nt // 2 + 1,)
    np.testing.assert_allclose(out, ref, rtol=1e-14, atol=1e-15)


def test_bandpass_matches_jax():
    """Value and gradient under a random cotangent, and the precomputed
    response applied through apply_bandpass_amplitude."""
    d, ct = _data(1)
    corners = (3.0, 8.0, 20.0, 40.0)
    out_j, pull = jax.vjp(lambda x: jsg.bandpass(x, DT, corners),
                          jnp.asarray(d))
    (g_j,) = pull(jnp.asarray(ct))
    x = _f64(d).requires_grad_()
    out_t = tsg.bandpass(x, DT, corners)
    (g_t,) = torch.autograd.grad(out_t, x, _f64(ct))
    _close(out_t.detach(), out_j, "bandpass")
    _close(g_t, g_j, "bandpass gradient")
    H = tsg.bandpass_amplitude(NT, DT, *corners)
    _close(tsg.apply_bandpass_amplitude(_f64(d), H), out_j,
           "apply_bandpass_amplitude")


def test_taper_window_per_trace_matches_jax():
    rng = np.random.default_rng(2)
    ws = rng.uniform(0, 40, 7)
    we = rng.uniform(60, NT - 1, 7)
    ref = np.asarray(jsg.taper_window(NT, DT, ws, we, ratio=0.05,
                                      dtype=jnp.float64))
    out = tsg.taper_window(NT, DT, _f64(ws), _f64(we), ratio=0.05,
                           dtype=F64).numpy()
    assert out.shape == (7, NT)
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-15)
    ref1 = np.asarray(jsg.taper_window(NT, DT, 10.0, 90.0,
                                       dtype=jnp.float64))
    np.testing.assert_allclose(tsg.taper_window(NT, DT, 10.0, 90.0,
                                                dtype=F64).numpy(),
                               ref1, rtol=1e-13, atol=1e-15)


def test_source_update_matches_jax():
    """The Wiener filter of a shot (complex, over receivers) and the
    corrected wavelet; the wavelet's gradient through the filter."""
    rng = np.random.default_rng(3)
    # broadband synthetics: where a band-limited one has no energy the
    # filter divides round-off by round-off, which no two FFTs share
    syn = rng.standard_normal((3, NT))
    obs = 2.5 * np.roll(syn, 2, axis=1) + 0.01 * rng.standard_normal(
        syn.shape)
    s = ricker(10.0, NT, DT, amp=1.0)
    W_j = jsg.source_update_filter(jnp.asarray(obs), jnp.asarray(syn))
    W_t = tsg.source_update_filter(_f64(obs), _f64(syn))
    _close(W_t.numpy(), np.asarray(W_j), "source_update_filter")
    ct = rng.standard_normal(NT)
    out_j, pull = jax.vjp(lambda w: jsg.apply_source_filter(w, W_j),
                          jnp.asarray(s))
    (g_j,) = pull(jnp.asarray(ct))
    x = _f64(s).requires_grad_()
    out_t = tsg.apply_source_filter(x, W_t)
    (g_t,) = torch.autograd.grad(out_t, x, _f64(ct))
    _close(out_t.detach(), out_j, "apply_source_filter")
    _close(g_t, g_j, "apply_source_filter gradient")
    # the filter recovers a pure scaling of a band-limited wavelet
    shots = np.stack([np.roll(s, k) for k in (5, 9, 13)])
    W = tsg.source_update_filter(_f64(2.5 * shots), _f64(shots))
    s_new = tsg.apply_source_filter(_f64(s), W).numpy()
    assert np.abs(s_new - 2.5 * s).max() < 1e-3 * np.abs(s).max()


@pytest.mark.parametrize("channels", [("ett",), ("pr", "vx", "vz")])
def test_crosscorr_matches_jax(channels):
    obs, syn = _data(4)
    _close(tmf.trace_normalize(_f64(obs)),
           jmf.trace_normalize(jnp.asarray(obs)), "trace_normalize")
    ref = float(jmf.normalized_crosscorr_misfit(jnp.asarray(obs),
                                                jnp.asarray(syn), channels))
    out = float(tmf.normalized_crosscorr_misfit(_f64(obs), _f64(syn),
                                                channels))
    assert out == pytest.approx(ref, rel=1e-13)
    assert float(tmf.normalized_crosscorr_misfit(
        _f64(obs), 2.0 * _f64(obs), channels)) < 1e-10  # amplitude-blind


# option name -> make_preprocessed_l2 keywords
OPTIONS = {
    "plain": {},
    "window": dict(window=(10.0, 100.0)),
    "filter": dict(filter_corners=(3.0, 8.0, 20.0, 40.0)),
    "per_trace": dict(per_trace=True),
    "dynamic": dict(dynamic_bandpass=True),
    "per_trace dynamic": dict(per_trace=True, dynamic_bandpass=True),
    "xcorr": dict(objective="xcorr"),
    "window filter xcorr": dict(window=(10.0, 100.0),
                                filter_corners=(0.0, 1e-4, 20.0, 45.0),
                                objective="xcorr"),
    "per_trace filter xcorr channels": dict(
        per_trace=True, filter_corners=(3.0, 8.0, 20.0, 40.0),
        objective="xcorr", channels=("pr", "vz")),
}
H_CORNERS = (0.0, 1e-4, 15.0, 40.0)


def _aux(kw, rng, S=None):
    """The per-shot (or, with S, per-chunk) aux arguments of an option."""
    lead = () if S is None else (S,)
    aux = []
    if kw.get("per_trace"):
        aux += [rng.uniform(0, 30, lead + (7,)),
                rng.uniform(80, NT - 1, lead + (7,)),
                rng.uniform(0.2, 2.0, lead + (7,))]
    if kw.get("dynamic_bandpass"):
        H = np.asarray(jsg.bandpass_amplitude(NT, DT, *H_CORNERS))
        aux.append(H if S is None else np.broadcast_to(H, (S, H.size)))
    return aux


@pytest.mark.parametrize("option", list(OPTIONS))
def test_preprocessed_misfit_matches_jax(option):
    """The per-shot objective: value and gradients to obs and syn."""
    kw = OPTIONS[option]
    rng = np.random.default_rng(len(option))
    obs, syn = _data(5)
    aux = _aux(kw, rng)
    jfn = jmf.make_preprocessed_l2(dt=DT, **kw)
    tfn = tmf.make_preprocessed_l2(dt=DT, **kw)
    val_j, (go_j, gs_j) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(obs), jnp.asarray(syn), *(jnp.asarray(a) for a in aux))
    o, s = _f64(obs).requires_grad_(), _f64(syn).requires_grad_()
    val_t = tfn(o, s, *(_f64(a) for a in aux))
    go_t, gs_t = torch.autograd.grad(val_t, (o, s))
    assert float(val_t.detach()) == pytest.approx(float(val_j), rel=1e-12)
    assert float(val_t.detach()) > 0
    _close(go_t, go_j, f"{option} obs gradient")
    _close(gs_t, gs_j, f"{option} syn gradient")


@pytest.mark.parametrize("option", ["per_trace dynamic",
                                    "per_trace filter xcorr channels",
                                    "window"])
def test_batched_equals_per_shot(option):
    """loss.batched on a 3-shot chunk gives each shot's per-shot value, and
    the gradient of the weighted sum equals the per-shot loop's."""
    kw = OPTIONS[option]
    rng = np.random.default_rng(6)
    obs, syn = _data(7, (3, 4, 7, NT))
    aux = [_f64(a) for a in _aux(kw, rng, S=3)]
    w = _f64([1.0, 0.25, 2.0])
    fn = tmf.make_preprocessed_l2(dt=DT, **kw)
    s1, s2 = _f64(syn).requires_grad_(), _f64(syn).requires_grad_()
    per = fn.batched(_f64(obs), s1, *aux)
    loop = torch.stack([fn(_f64(obs[i]), s2[i], *(a[i] for a in aux))
                        for i in range(3)])
    assert per.shape == (3,)
    np.testing.assert_allclose(per.detach().numpy(), loop.detach().numpy(),
                               rtol=1e-13)
    (g1,) = torch.autograd.grad((w * per).sum(), s1)
    (g2,) = torch.autograd.grad((w * loop).sum(), s2)
    _close(g1, g2, "batched gradient", tol=1e-13)
    assert parallel._over_shots(fn) is fn.batched


def test_dynamic_bandpass_matches_static():
    """dynamic_bandpass fed the precomputed response equals the static
    filter_corners build, value and gradient."""
    obs, syn = _data(8)
    corners = (0.0, 1e-4, 2.0, 4.5)
    static = tmf.make_preprocessed_l2(dt=DT, filter_corners=corners)
    dynamic = tmf.make_preprocessed_l2(dt=DT, dynamic_bandpass=True)
    H = tsg.bandpass_amplitude(NT, DT, *corners)
    s1, s2 = _f64(syn).requires_grad_(), _f64(syn).requires_grad_()
    a, b = static(_f64(obs), s1), dynamic(_f64(obs), s2, H)
    assert float(a.detach()) == pytest.approx(float(b.detach()), rel=1e-12)
    (ga,) = torch.autograd.grad(a, s1)
    (gb,) = torch.autograd.grad(b, s2)
    _close(gb, ga, "dynamic gradient")


def _loss_problem():
    npml = 6
    cfg = SimConfig(nz=24 + 2 * npml, nx=32 + 2 * npml, dz=20.0, dx=20.0,
                    nt=70, dt=0.002, f0=10.0, npml=npml)
    survey = Survey(src_z=np.ones(3), src_x=np.array([6, 16, 26]),
                    rec_z=np.full(20, 14), rec_x=np.arange(6, 26))
    vp = np.full((cfg.nz, cfg.nx), 3000.0)
    vp[14:20, 16:28] += 200.0
    rho = np.full((cfg.nz, cfg.nx), 2500.0)
    lam, mu = (vp ** 2 - 2 * (vp / np.sqrt(3)) ** 2) * rho, vp ** 2 / 3 * rho
    stf = np.stack([ricker(10.0, cfg.nt, cfg.dt) * (1 + 0.1 * s)
                    for s in range(3)])
    return cfg, survey, (lam, mu, rho), stf


@pytest.mark.parametrize("case,chunk,tol", [
    ("l2 per-trace dynamic", 0, 1e-10), ("l2 per-trace dynamic", 2, 1e-10),
    ("xcorr", 2, 1e-10), ("xcorr window", 0, 1e-8)])
def test_local_misfit_with_trace_aux_matches_jax(case, chunk, tol):
    """make_local_misfit with a conditioned misfit: its trace_aux are
    chunked with the shots; value and model/stf gradients equal the JAX
    package's to 1e-10, and to 1e-8 for the windowed cross-correlation,
    whose model gradient is a near-cancellation of its adjoint source's
    terms (ROADMAP Queue 3): the adjoint sources agree to round-off, the
    gradients only as far as the cancellation leaves them."""
    cfg, survey, model, stf = _loss_problem()
    # windows that keep every trace's arrival
    rng = np.random.default_rng(9)
    aux = []
    if case.startswith("l2"):
        kw = dict(per_trace=True, dynamic_bandpass=True)
        aux = [rng.uniform(0, 10, (3, 20)),
               rng.uniform(cfg.nt - 10, cfg.nt - 1, (3, 20)),
               rng.uniform(0.2, 2.0, (3, 20)),
               np.broadcast_to(tsg.bandpass_amplitude(
                   cfg.nt, cfg.dt, *H_CORNERS).numpy(), (3, cfg.nt // 2 + 1))]
    elif case == "xcorr":
        kw = dict(objective="xcorr")
    else:
        kw = dict(objective="xcorr", window=(5.0, 65.0))
    w = np.array([1.0, 0.5, 2.0])
    jgeoms = jpar.survey_to_geoms(survey, cfg.npml, dtype=jnp.float64)
    obs = jax.vmap(lambda s, g: jprop.propagate(
        cfg, *(jnp.asarray(m) * f for m, f in zip(model, (1.03, 1.0, 1.0))),
        s, g))(jnp.asarray(stf), jgeoms)

    jloss = jpar.make_local_misfit(
        cfg, misfit_fn=jmf.make_preprocessed_l2(dt=cfg.dt, **kw),
        shot_chunk=chunk)
    val_j, g_j = jax.value_and_grad(
        lambda m, s: jloss(*m, s, jgeoms, obs, jnp.asarray(w),
                           *(jnp.asarray(a) for a in aux)),
        argnums=(0, 1))(tuple(jnp.asarray(m) for m in model),
                        jnp.asarray(stf))

    geoms = parallel.survey_to_geoms(survey, cfg.npml, device="cpu",
                                     dtype=F64)
    tloss = parallel.make_local_misfit(
        cfg, misfit_fn=tmf.make_preprocessed_l2(dt=cfg.dt, **kw),
        shot_chunk=chunk)
    ps = [_f64(a).requires_grad_() for a in (*model, stf)]
    val_t = tloss(*ps, geoms, _f64(obs), _f64(w), *(_f64(a) for a in aux))
    g_t = torch.autograd.grad(val_t, ps)
    assert float(val_t.detach()) == pytest.approx(float(val_j), rel=1e-10)
    assert float(val_t.detach()) > 1e-6
    # the model gradients on the interior less 2 cells, as
    # tests/test_torch_gradient.py compares them (the edge band differs
    # between the two adjoints by round-off, ROADMAP Queue 3)
    m = slice(cfg.npml + 2, -cfg.npml - 2)
    for a, b in zip(g_t[:3], g_j[0]):
        _close(a[m, m], np.asarray(b)[m, m], "model gradient", tol=tol)
    _close(g_t[3], g_j[1], "stf gradient", tol=tol)


def test_cuda_misfit_with_trace_aux_on_cpu():
    """make_cuda_misfit, the kernels' loss builder, with the conditioned
    misfit's batched form and its trace_aux, on CPU tensors (the kernels'
    plain versions, float32): in chunks of 2 over 3 shots it equals one
    chunk, and one chunk equals make_local_misfit within the float32
    bounds of tests/test_torch_gradient.py (5e-4 on the interior less 2
    cells)."""
    f32 = torch.float32
    cfg, survey, model, stf = _loss_problem()
    rng = np.random.default_rng(10)
    aux = [torch.tensor(np.asarray(a), dtype=f32) for a in (
        rng.uniform(0, 10, (3, 20)), rng.uniform(cfg.nt - 10, cfg.nt - 1,
                                                  (3, 20)),
        rng.uniform(0.2, 2.0, (3, 20)),
        np.broadcast_to(tsg.bandpass_amplitude(
            cfg.nt, cfg.dt, *H_CORNERS).numpy(), (3, cfg.nt // 2 + 1)))]
    fn = tmf.make_preprocessed_l2(dt=cfg.dt, per_trace=True,
                                  dynamic_bandpass=True)
    t32 = lambda a: torch.tensor(np.asarray(a), dtype=f32)
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device="cpu",
                                     dtype=f32)
    w = t32([1.0, 0.5, 2.0])
    obs = parallel.make_forward(cfg, survey, use_kernels=False, device="cpu",
                                dtype=f32)(*(t32(m * f) for m, f in zip(
                                    model, (1.03, 1.0, 1.0))), t32(stf))

    def run(make):
        ps = [t32(a).requires_grad_() for a in (*model, stf)]
        val = make(ps)
        return float(val.detach()), torch.autograd.grad(val, ps)

    def cuda_loss(chunk):
        return lambda ps: parallel.make_cuda_misfit(
            cfg, survey, misfit_fn=fn, shot_chunk=chunk)(*ps, obs, w, *aux)

    v2, g2 = run(cuda_loss(2))
    v0, g0 = run(cuda_loss(0))
    v_l, g_l = run(lambda ps: parallel.make_local_misfit(
        cfg, misfit_fn=fn)(*ps, geoms, obs, w, *aux))
    assert v2 == pytest.approx(v0, rel=1e-5) and v0 > 0
    assert v0 == pytest.approx(v_l, rel=1e-4)
    m = slice(cfg.npml + 2, -cfg.npml - 2)
    for a, b, c in zip(g2[:3], g0[:3], g_l[:3]):
        _close(a, b, "chunked model gradient", tol=1e-5)
        _close(b[m, m], c[m, m], "model gradient", tol=5e-4)
    _close(g2[3], g0[3], "chunked stf gradient", tol=1e-5)
    _close(g0[3], g_l[3], "stf gradient", tol=5e-4)
