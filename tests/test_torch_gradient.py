"""The port's gradient against the JAX package's and against itself.

* propagator.propagate_shots (the boundary-saving autograd.Function) against
  propagator.propagate_ad (plain autograd through every step) and against
  the JAX engine's custom_vjp under jax.grad, float64: 1e-12 of each
  gradient's max.
* A central finite difference, the adjoint dot product and the
  reconstruction back to t=0, as the JAX package's tests/test_gradient.py
  and tests/test_reconstruction.py hold its engine.
* The kernels' plain versions (forward_cuda_plan / backward_cuda_plan on CPU
  tensors, so forward_plain_strips / backward_plain) against the Pallas
  engine's propagate_pallas gradients in interpret mode, float32: 5e-4 of each
  gradient's max, the bound of the JAX package's own Pallas-vs-XLA test
  (tests/test_pallas_engine.py:166).

Model gradients are compared on the interior shrunk by 2 cells, as in the
JAX package's tests: the material averaging reaches one cell past the
interior mask.  Inputs are numpy arrays made from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu import parallel
from sep2023_tpu.config import Survey
from sep2023_tpu.ops import misfit as jmf
from sep2023_tpu.ops import pallas_engine as pe
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import convert, propagator
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.ops import misfit as tmf

MARGIN = 2


def _problem(npml, nz, nx, nt, das_channel="exx", seed=3):
    """Random model around 3000 m/s with a fast box, 2 shots near the top,
    one receiver row 12 rows below them (direct arrivals inside nt)."""
    kw = dict(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0, nt=nt,
              dt=0.002, f0=10.0, npml=npml, das_channel=das_channel)
    rng = np.random.default_rng(seed)
    shape = (kw["nz"], kw["nx"])
    vp = 3000.0 + 50.0 * rng.standard_normal(shape)
    vp[npml + 16:npml + 22, npml + 20:npml + 32] += 250.0
    vs = vp / np.sqrt(3.0)
    rho = 2500.0 + 20.0 * rng.standard_normal(shape)
    survey = Survey(src_z=np.array([2, 2]), src_x=np.array([10, nx - 14]),
                    rec_z=np.full(nx - 16, 14), rec_x=np.arange(8, nx - 8),
                    src_rxz=np.array([1.0, 1.6]))
    stf = np.stack([st.ricker(10.0, nt, 0.002),
                    0.5 * st.ricker(12.0, nt, 0.002)])
    return (st.SimConfig(**kw), tcfg.SimConfig(**kw),
            ((vp ** 2 - 2.0 * vs ** 2) * rho, vs ** 2 * rho, rho), stf,
            survey)


def _interior(cfg, a):
    m = cfg.npml + MARGIN
    return a[..., m:cfg.nz - m, m:cfg.nx - m]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _assert_grads_close(cfg, out, ref, tol):
    for name, a, b in zip(("lam", "mu", "rho", "stf"), out, ref):
        if name != "stf":
            a, b = _interior(cfg, a), _interior(cfg, b)
        assert _rel(a, b) < tol, (name, _rel(a, b))


@pytest.fixture(scope="module")
def f64():
    """float64 problem of both packages, and the observed data of the model
    with lam raised by 2% and mu lowered by 2%."""
    jcfg, tcfg_, (lam, mu, rho), stf, survey = _problem(8, 30, 44, 120)
    geoms = parallel.survey_to_geoms(survey, 8, dtype=jnp.float64)
    args = convert.params_from_numpy(lam, mu, rho, stf, geoms, device="cpu",
                                     dtype=torch.float64)
    obs = propagator.propagate_ad(tcfg_, args[0] * 1.02, args[1] * 0.98,
                                  *args[2:]).detach()
    return jcfg, tcfg_, (lam, mu, rho, stf), geoms, args, obs


def _port_grads(cfg, fn, args, obs):
    lam, mu, rho, stf, geoms = args
    ps = [a.clone().requires_grad_() for a in (lam, mu, rho, stf)]
    loss = tmf.l2_misfit(obs, fn(cfg, *ps, geoms))
    grads = torch.autograd.grad(loss, ps)
    return float(loss.detach()), [g.numpy() for g in grads]


def test_adjoint_matches_plain_autograd_f64(f64):
    _, cfg, _, _, args, obs = f64
    l1, g_bs = _port_grads(cfg, propagator.propagate_shots, args, obs)
    l2, g_ad = _port_grads(cfg, propagator.propagate_ad, args, obs)
    assert l1 == pytest.approx(l2, rel=1e-14) and l1 > 0
    _assert_grads_close(cfg, g_bs, g_ad, 1e-12)


def test_adjoint_matches_jax_f64(f64):
    jcfg, cfg, (lam, mu, rho, stf), geoms, args, obs = f64
    obs_j = jnp.asarray(obs.numpy())

    def loss_j(l, m, r, s):
        syn = jax.vmap(lambda si, g: st.propagate(jcfg, l, m, r, si, g))(
            s, geoms)
        return jmf.l2_misfit(obs_j, syn)

    val_j = float(loss_j(lam, mu, rho, stf))
    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (lam, mu, rho, stf)))
    val, g = _port_grads(cfg, propagator.propagate_shots, args, obs)
    assert val == pytest.approx(val_j, rel=1e-12)
    for name, a, b in zip(("lam", "mu", "rho", "stf"), g, g_j):
        assert _rel(a, b) < 1e-12, (name, _rel(a, b))


def test_finite_difference_f64(f64):
    """A central difference of the misfit along a random interior model
    perturbation matches <grad, v> to 1e-5 (tests/test_gradient.py)."""
    _, cfg, _, _, args, obs = f64
    lam, mu, rho, stf, geoms = args
    _, g = _port_grads(cfg, propagator.propagate_shots, args, obs)
    mask = torch.zeros((cfg.nz, cfg.nx), dtype=torch.float64)
    m = cfg.npml + MARGIN
    mask[m:cfg.nz - m, m:cfg.nx - m] = 1.0
    rng = np.random.default_rng(7)
    base = [lam, mu, rho]
    loss = lambda p: float(tmf.l2_misfit(obs, propagator.propagate_shots(
        cfg, *p, stf, geoms)))
    for i, name in enumerate(("lam", "mu", "rho")):
        v = torch.from_numpy(rng.standard_normal((cfg.nz, cfg.nx))) \
            * mask * base[i]
        eps = 1e-6
        hi, lo = list(base), list(base)
        hi[i] = base[i] + eps * v
        lo[i] = base[i] - eps * v
        fd = (loss(hi) - loss(lo)) / (2 * eps)
        dot = float((torch.from_numpy(g[i]) * v).sum())
        assert abs(fd - dot) / abs(dot) < 1e-5, (name, fd, dot)


def test_adjoint_dot_product_f64(f64):
    """<J v, w> = <v, J^T w> for (lam, mu, rho, stf) -> data: J v by
    forward-mode AD through propagate_ad, J^T w by the boundary-saving
    adjoint."""
    _, cfg, _, _, args, _ = f64
    lam, mu, rho, stf, geoms = args
    rng = np.random.default_rng(42)
    t = lambda shape: torch.from_numpy(rng.standard_normal(shape))
    mask = torch.zeros((cfg.nz, cfg.nx), dtype=torch.float64)
    m = cfg.npml + MARGIN
    mask[m:cfg.nz - m, m:cfg.nx - m] = 1.0
    v = (t(lam.shape) * mask * lam, t(mu.shape) * mask * mu,
         t(rho.shape) * mask * rho, t(stf.shape))
    _, jv = torch.func.jvp(
        lambda *p: propagator.propagate_ad(cfg, *p, geoms),
        (lam, mu, rho, stf), v)
    w = t(jv.shape)
    ps = [a.clone().requires_grad_() for a in (lam, mu, rho, stf)]
    out = propagator.propagate_shots(cfg, *ps, geoms)
    vt = torch.autograd.grad(out, ps, w)
    lhs = float((jv * w).sum())
    rhs = float(sum((a * b).sum() for a, b in zip(v, vt)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-10


def test_reconstruction_returns_to_zero_f64():
    """The time-reversed reconstruction from the final fields and strips
    brings the interior stresses back to zero at t=0, to 1e-6 of the peak
    |pr| (tests/test_reconstruction.py)."""
    _, cfg, (lam, mu, rho), stf, survey = _problem(10, 40, 56, 400)
    geoms = parallel.survey_to_geoms(survey, 10, dtype=jnp.float64)
    lam, mu, rho, stf, g = convert.params_from_numpy(
        lam, mu, rho, stf, geoms, device="cpu", dtype=torch.float64)
    data, final, strips = propagator._forward(cfg, lam, mu, rho, stf, g,
                                              save_bnd=True)
    f0 = propagator.reconstruct(cfg, lam, mu, rho, stf, g, final, strips)
    scale = float(data[:, 0].abs().max())
    zi, xi = cfg.grid.interior_slices()
    assert float(final.szz[:, zi, xi].abs().max()) > 1e-3 * scale
    for name, a in zip(("szz", "sxx", "sxz"), (f0.szz, f0.sxx, f0.sxz)):
        assert float(a[:, zi, xi].abs().max()) < 1e-6 * scale, name


@pytest.mark.parametrize("das_channel", ["exx", "ezz"])
def test_plain_strips_and_backward_match_pallas(das_channel):
    """forward_cuda_plan(save_strips=True) and backward_cuda_plan on CPU
    tensors (their plain versions) against propagate_pallas in interpret
    mode, float32; nt=141 leaves a partial final strip chunk in the Pallas
    engine."""
    jcfg, cfg, mats, stf, survey = _problem(10, 40, 56, 141, das_channel)
    f32 = np.float32
    lam, mu, rho = (jnp.asarray(a, jnp.float32) for a in mats)
    stf_j = jnp.asarray(stf, jnp.float32)
    rs = pe.check_row_survey(survey.rec_z + 10, survey.rec_x + 10)
    sz, sx = survey.src_z + 10, survey.src_x + 10
    rz = survey.src_rxz
    obs = pe.forward_pallas(jcfg, rs, lam * 1.03, mu, rho, stf_j, sz, sx, rz)

    def loss_pal(l, m, r, s):
        return jmf.l2_misfit(obs, pe.propagate_pallas(
            jcfg, rs, l, m, r, s, jnp.asarray(sz), jnp.asarray(sx),
            jnp.asarray(rz)))

    g_pal = jax.grad(loss_pal, argnums=(0, 1, 2, 3))(lam, mu, rho, stf_j)
    data_pal = np.asarray(pe.forward_pallas(jcfg, rs, lam, mu, rho, stf_j,
                                            sz, sx, rz))

    trs = cuda_engine.check_row_survey(survey.rec_z + 10, survey.rec_x + 10)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, f32))
    inputs = (t(mats[0]), t(mats[1]), t(mats[2]), t(stf), sz, sx, rz)
    before = (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_BWD,
              dict(cuda_engine.PLAIN_CALLS))
    plan = cuda_engine.plan_for(cfg, trs)
    data, strips, final = cuda_engine.forward_cuda_plan(plan, *inputs,
                                                        save_strips=True)
    assert strips.shape == (2, 140, 5, propagator.strip_len(cfg))
    assert final.shape == (5, 2, cfg.nz, cfg.nx)
    d = torch.zeros_like(data)
    d[:, 3] = -tmf.residual(torch.from_numpy(np.array(obs)), data)[:, 3]
    g = cuda_engine.backward_cuda_plan(plan, *inputs, final, strips, d)
    # CPU tensors take the plain versions and launch nothing
    assert (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_BWD) == before[:2]
    calls = cuda_engine.PLAIN_CALLS
    assert calls["forward_plain_strips"] == \
        before[2]["forward_plain_strips"] + 1
    assert calls["backward_plain"] == before[2]["backward_plain"] + 1

    ett = np.abs(data_pal[:, 3])
    assert ett.max() > 1e-3 and ett[..., :20].max() < 1e-6 * ett.max()
    for c in range(4):
        assert _rel(data[:, c].numpy(), data_pal[:, c]) < 2e-5, c
    _assert_grads_close(cfg, [a.numpy() for a in g],
                        [np.asarray(a) for a in g_pal], 5e-4)


def test_propagate_cuda_on_cpu_is_the_plain_adjoint():
    """propagate_cuda_plan's gradient on CPU tensors is backward_plain's, which
    is propagator.propagate_shots' on the same row survey."""
    _, cfg, mats, stf, survey = _problem(8, 24, 36, 90)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    sz, sx, rz = survey.src_z + 8, survey.src_x + 8, survey.src_rxz
    rs = cuda_engine.check_row_survey(survey.rec_z + 8, survey.rec_x + 8)
    plan = cuda_engine.plan_for(cfg, rs)
    obs = cuda_engine.forward_cuda_plan(plan, f32(mats[0]) * 1.03,
                                        f32(mats[1]), f32(mats[2]), f32(stf),
                                        sz, sx, rz)
    ps = [f32(a).requires_grad_() for a in (*mats, stf)]
    loss = tmf.l2_misfit(obs, cuda_engine.propagate_cuda_plan(plan, *ps, sz,
                                                              sx, rz))
    g = torch.autograd.grad(loss, ps)
    geoms = cuda_engine._geoms(cfg, rs, sz, sx, rz, "cpu", torch.float32)
    qs = [f32(a).requires_grad_() for a in (*mats, stf)]
    loss_p = tmf.l2_misfit(obs, propagator.propagate_shots(cfg, *qs, geoms))
    g_p = torch.autograd.grad(loss_p, qs)
    assert float(loss.detach()) == float(loss_p.detach()) > 0
    for a, b in zip(g, g_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(165, 265), (265, 385), (465, 640),
                                   (528, 704), (560, 720), (814, 2064)])
def test_fused_range_matches_jax(shape, monkeypatch):
    """The JAX package's fused range (grad_vmem_fits: 165x265 to 528x704
    inside, 560x720 and 814x2064 past it, its streamed pair's grids) gates
    nothing in the port: at every one of these grids a gradient through
    propagate_cuda_plan on a device that is not the CPU reaches the kernel
    wrapper's build (made to fail here) and no plain version."""
    from sep2023_tpu_torch.ops import _build

    def broken_build():
        raise RuntimeError("nvcc failed (simulated)")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA entry point ran a plain version")

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", broken_build)
    for name in ("forward_plain", "forward_plain_strips", "backward_plain"):
        monkeypatch.setattr(cuda_engine, name, no_plain)
    nz, nx = shape
    kw = dict(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=2001, dt=0.001, f0=10.0,
              npml=32)
    assert pe.grad_vmem_fits(st.SimConfig(**kw)) == (nz < 560)
    cfg = tcfg.SimConfig(**kw)
    plan = cuda_engine.plan_fast_path(cfg, np.full(nx - 84, nz - 44),
                                      np.arange(42, nx - 42))
    assert plan.rs == cuda_engine.RowSurvey(nz - 44, 42, nx - 84)
    meta = lambda *s_: torch.zeros(s_, device="meta").requires_grad_()
    before = (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_BWD)
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_engine.propagate_cuda_plan(
            plan, meta(nz, nx), meta(nz, nx), meta(nz, nx), meta(1, 2001),
            np.array([33]), np.array([nx // 2]), np.ones(1))
    assert (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_BWD) == before
