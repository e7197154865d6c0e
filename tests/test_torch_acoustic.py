"""The port's acoustic physics against the JAX package's and against itself.

* float64, the plain propagator (acoustic.py) against the JAX XLA acoustic
  engine (sep2023_tpu/acoustic.py): data within 1e-12 of each channel's max;
  gradients of (lam, rho, stf) through the boundary-saving Function within
  1e-10 of the JAX custom_vjp's and of the port's own plain autograd
  (`propagate_acoustic_ad`), the model gradients 4 cells away from the PML
  (tests/test_acoustic.py:53-61); a central finite difference (1e-6), the
  adjoint dot product (1e-10) and the reconstruction back to t=0 against the
  stored zero state (1e-9 of the peak pressure).
* float32, the kernels' wrappers on CPU tensors (so their plain versions)
  against the Pallas kernels in interpret mode: `forward_pallas_acoustic` /
  `propagate_pallas_acoustic` (data 2e-5, gradients 5e-5 on
  [npml+2, n-npml-2), the bounds of tests/test_acoustic.py:101-104, 194-201)
  and `propagate_pallas_acoustic_streamed` with several z-tiles (3e-5, 5e-4,
  tests/test_pallas_stream.py:307-328); on a receiver row and on points
  that visit a cell three times.  A receiver column, which the Pallas
  engine does not plan for the acoustic mode, is held against the XLA
  engine in float32 (2e-5, 5e-5).
* `rtm_image_time` with the illumination against the JAX package's (1e-10 of
  each one's max, float64), and its locality and sign test mirrored.
* The wrappers raise on a device that is neither the CPU nor CUDA, on
  float64 and on a wrong shape, and reach no plain version there.
* `strip_bytes_per_shot`, `state_bytes_per_shot` and `auto_shot_chunk` with
  `acoustic=True`.

Inputs are numpy arrays made from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu import acoustic as jac
from sep2023_tpu.ops import pallas_engine as pe
from sep2023_tpu.ops import pallas_stream as ps
from sep2023_tpu_torch import acoustic as tac
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import convert
from sep2023_tpu_torch import parallel as tpar
from sep2023_tpu_torch import propagator
from sep2023_tpu_torch.ops import cuda_acoustic as ca
from sep2023_tpu_torch.ops import cuda_engine as ce

F64_DATA_TOL = 1e-12
F64_GRAD_TOL = 1e-10
PALLAS_FWD_TOL, PALLAS_GRAD_TOL = 2e-5, 5e-5    # tests/test_acoustic.py
STREAM_FWD_TOL, STREAM_GRAD_TOL = 3e-5, 5e-4    # tests/test_pallas_stream.py


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _configs(nz, nx, nt, npml):
    kw = dict(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0, nt=nt,
              dt=0.002, f0=10.0, npml=npml)
    return st.SimConfig(**kw), tcfg.SimConfig(**kw)


def _model(cfg, seed=3, noise=40.0):
    """Seeded vp around 3000 m/s with a fast box, and a rough rho: numpy
    float64 (lam = rho vp^2, rho)."""
    rng = np.random.default_rng(seed)
    vp = 3000.0 + noise * rng.standard_normal((cfg.nz, cfg.nx))
    n = cfg.npml
    vp[n + 16:n + 22, n + 20:n + 32] += 250.0
    rho = 2400.0 + 20.0 * rng.standard_normal((cfg.nz, cfg.nx))
    return rho * vp ** 2, rho


def _jgeoms(sz, sx, rz, rx):
    S = len(sz)
    return jac.AcGeom(src_z=np.asarray(sz), src_x=np.asarray(sx),
                      rec_z=np.broadcast_to(rz, (S, len(rz))),
                      rec_x=np.broadcast_to(rx, (S, len(rx))))


def _jax_shots(jcfg, geoms):
    """The JAX XLA engine over the shot axis (its custom_vjp underneath)."""
    return lambda lam, rho, stf: jax.vmap(
        lambda s, g: jac.propagate_acoustic(jcfg, lam, rho, s, g))(
            stf, jax.tree.map(jnp.asarray, geoms))


@pytest.fixture(scope="module")
def f64():
    """A float64 problem of both packages on a 40x56 grid (npml 10, padded
    60x76), 2 shots, a receiver row 14 rows under them with one receiver
    doubled, nt=130; obs is the data of the model with lam raised by 3%."""
    jcfg, cfg = _configs(40, 56, 130, 10)
    lam, rho = _model(cfg)
    stf = np.stack([st.ricker(10.0, 130, 0.002),
                    0.6 * st.ricker(12.0, 130, 0.002)])
    rz = np.full(41, 26)
    rx = np.concatenate([np.arange(14, 54), [20]])
    geoms = _jgeoms([12, 12], [22, 50], rz, rx)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    args = (t(lam), t(rho), t(stf),
            convert.acgeom_from_jax(geoms, device="cpu"))
    obs = tac.propagate_acoustic_ad(cfg, args[0] * 1.03, *args[1:]).detach()
    return jcfg, cfg, (lam, rho, stf), geoms, args, obs


def _interior(cfg, a, s=4):
    m = cfg.npml + s
    return a[..., m:cfg.nz - m, m:cfg.nx - m]


def _port_grads(cfg, fn, args, obs):
    lam, rho, stf, geoms = args
    ps_ = [a.clone().requires_grad_() for a in (lam, rho, stf)]
    r = obs - fn(cfg, *ps_, geoms)
    r[..., 0] = 0.0
    loss = 0.5 * (r * r).sum()
    return float(loss.detach()), [g.numpy() for g in
                                  torch.autograd.grad(loss, ps_)]


def _assert_grads_close(cfg, out, ref, tol, s=4):
    for name, a, b in zip(("lam", "rho", "stf"), out, ref):
        if name != "stf":
            a, b = _interior(cfg, np.asarray(a), s), \
                _interior(cfg, np.asarray(b), s)
        assert np.abs(np.asarray(b)).max() > 0, name
        assert _rel(a, b) < tol, (name, _rel(a, b))


def test_forward_matches_jax_f64(f64):
    jcfg, cfg, (lam, rho, stf), geoms, args, _ = f64
    ref = np.asarray(_jax_shots(jcfg, geoms)(
        jnp.asarray(lam), jnp.asarray(rho), jnp.asarray(stf)))
    out = tac.propagate_acoustic_shots(cfg, *args).numpy()
    assert out.shape == ref.shape == (2, 3, 41, 130)
    assert (out[..., 0] == 0).all()
    for c in range(3):
        assert np.abs(ref[:, c]).max() > 0
        assert _rel(out[:, c], ref[:, c]) < F64_DATA_TOL, c
    # one shot through the single-shot entry, the package's export
    from sep2023_tpu_torch import AcGeom, propagate_acoustic
    one = propagate_acoustic(cfg, args[0], args[1], args[2][1],
                             AcGeom(*(g[1] for g in args[3])))
    assert torch.equal(one, torch.from_numpy(out[1]))


def test_adjoint_matches_jax_and_plain_autograd_f64(f64):
    jcfg, cfg, (lam, rho, stf), geoms, args, obs = f64
    l_bs, g_bs = _port_grads(cfg, tac.propagate_acoustic_shots, args, obs)
    l_ad, g_ad = _port_grads(cfg, tac.propagate_acoustic_ad, args, obs)
    assert l_bs == l_ad > 0
    _assert_grads_close(cfg, g_bs, g_ad, F64_GRAD_TOL)

    fwd = _jax_shots(jcfg, geoms)
    obs_j = jnp.asarray(obs.numpy())

    def loss(lam_, rho_, stf_):
        r = (obs_j - fwd(lam_, rho_, stf_)).at[..., 0].set(0.0)
        return 0.5 * jnp.sum(r * r)

    g_j = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(lam), jnp.asarray(rho), jnp.asarray(stf))
    # the same masked interior in both packages: compare it whole
    _assert_grads_close(cfg, g_bs, g_j, F64_GRAD_TOL, s=0)
    assert (g_bs[2][:, -1] == 0).all()


def test_finite_difference_f64(f64):
    _, cfg, _, _, args, obs = f64
    lam, rho, stf, geoms = args
    _, (g_lam, _, _) = _port_grads(cfg, tac.propagate_acoustic_shots, args,
                                   obs)
    rng = np.random.default_rng(5)
    d = np.zeros((cfg.nz, cfg.nx))
    m = cfg.npml + 6
    d[m:-m, m:-m] = rng.standard_normal((cfg.nz - 2 * m, cfg.nx - 2 * m))
    d = torch.from_numpy(d * float(lam.mean()) * 1e-4)

    def loss(l):
        r = obs - tac.propagate_acoustic_ad(cfg, l, rho, stf, geoms)
        r[..., 0] = 0.0
        return float(0.5 * (r * r).sum())

    fd_val = (loss(lam + d) - loss(lam - d)) / 2.0
    an = float((torch.from_numpy(g_lam) * d).sum())
    assert abs(fd_val - an) / abs(an) < 1e-6, (fd_val, an)


def test_adjoint_dot_product_f64(f64):
    _, cfg, _, _, args, _ = f64
    lam, rho, stf, geoms = args
    rng = np.random.default_rng(7)
    s = torch.from_numpy(rng.standard_normal(tuple(stf.shape))
                         ).requires_grad_()
    d = torch.from_numpy(rng.standard_normal((2, 3, 41, 130)))
    data = tac.propagate_acoustic_shots(cfg, lam, rho, s, geoms)
    lhs = float((d * data.detach()).sum())
    (g,) = torch.autograd.grad(data, s, d)
    rhs = float((g * s.detach()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-10


def test_reconstruction_f64(f64):
    _, cfg, _, _, args, _ = f64
    lam, rho, stf, geoms = args
    data, final, strips = tac._forward(cfg, lam, rho, stf, geoms,
                                       save_bnd=True)
    assert strips.shape == (2, 129, 3, propagator.strip_len(cfg))
    f0 = tac.reconstruct(cfg, lam, rho, stf, geoms, final, strips)
    n = cfg.npml + 2
    peak = float(data[:, 0].abs().max())
    for a in f0:  # the state before step 0 is zero
        assert float(a[:, n:-n, n:-n].abs().max()) < 1e-9 * peak


# ---------------------------------------------------------------------------
# float32: the wrappers on CPU tensors against the Pallas kernels
# ---------------------------------------------------------------------------

ROW = (np.full(24, 32), np.arange(16, 40))
# x=25 three times on row 30 (three layers of the JAX fiber plan), 18..23
# on rows 30 and 31
POINTS = (np.array([30] * 14 + [31] * 6),
          np.array(list(range(14, 26)) + [25, 25] + list(range(18, 24))))
COLUMN = (np.arange(8, 34), np.full(26, 40))


def _f32_problem(nt=141):
    npml = 10
    jcfg, cfg = _configs(40, 56, nt, npml)
    lam, rho = _model(cfg, noise=20.0)
    lam, rho = lam.astype(np.float32), rho.astype(np.float32)
    stf = np.stack([st.ricker(10.0, nt, 0.002),
                    0.7 * st.ricker(10.0, nt, 0.002)]).astype(np.float32)
    sz, sx = np.array([2, 2]) + npml, np.array([12, 36]) + npml
    return jcfg, cfg, lam, rho, stf, sz, sx


def _port_f32(cfg, rs, lam, rho, stf, sz, sx, obs):
    """Data and gradients of 0.5 |obs - syn|^2 through the wrappers on CPU
    tensors; the plain versions run, and nothing is launched."""
    plan = ce.plan_for(cfg, rs)
    ps_ = [torch.from_numpy(a.copy()).requires_grad_()
           for a in (lam, rho, stf)]
    before = (ca.LAUNCHES_AC, ca.LAUNCHES_AC_BWD, dict(ce.PLAIN_CALLS))
    syn = ca.propagate_cuda_acoustic_plan(plan, *ps_, sz, sx)
    r = torch.from_numpy(np.array(obs)) - syn
    g = torch.autograd.grad(0.5 * (r * r).sum(), ps_)
    assert (ca.LAUNCHES_AC, ca.LAUNCHES_AC_BWD) == before[:2]
    for k in ("forward_plain_acoustic_strips", "backward_plain_acoustic"):
        assert ce.PLAIN_CALLS[k] == before[2][k] + 1
    data = ca.forward_cuda_acoustic_plan(plan, *(p.detach() for p in ps_),
                                         sz, sx)
    assert torch.equal(data, syn.detach())
    return data.numpy(), [a.numpy() for a in g]


def _assert_f32(cfg, out, g, ref, g_ref, fwd_tol, grad_tol, margin=2):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    for c in range(3):
        assert np.abs(ref[:, c]).max() > 1e-3
        assert _rel(out[:, c], ref[:, c]) < fwd_tol, (c, _rel(out[:, c],
                                                             ref[:, c]))
    _assert_grads_close(cfg, g, g_ref, grad_tol, s=margin)


@pytest.mark.parametrize("rec", [ROW, POINTS], ids=["row", "points"])
def test_wrappers_match_fused_pallas_f32(rec):
    jcfg, cfg, lam, rho, stf, sz, sx = _f32_problem()
    rz, rx = rec[0] + 10, rec[1] + 10
    jplan = pe.plan_fast_path(jcfg, rz, rx)
    assert not jplan.transposed
    plan = ce.plan_fast_path(cfg, rz, rx)
    assert isinstance(plan.rs, ce.RowSurvey) == isinstance(jplan.rs,
                                                           pe.RowSurvey)
    j = lambda a: jnp.asarray(a)
    obs = pe.forward_pallas_acoustic(jcfg, jplan.rs, j(lam) * 1.03, j(rho),
                                     j(stf), sz, sx)
    ref = pe.forward_pallas_acoustic(jcfg, jplan.rs, j(lam), j(rho), j(stf),
                                     sz, sx)

    def loss(l, r, s):
        d = obs - pe.propagate_pallas_acoustic(jcfg, jplan.rs, l, r, s,
                                               j(sz), j(sx))
        return 0.5 * jnp.sum(d * d)

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(j(lam), j(rho), j(stf))
    out, g = _port_f32(cfg, plan.rs, lam, rho, stf, sz, sx, obs)
    _assert_f32(cfg, out, g, ref, g_ref, PALLAS_FWD_TOL, PALLAS_GRAD_TOL)


def test_wrappers_match_streamed_pallas_f32(monkeypatch):
    monkeypatch.setenv("SEP2023_TPU_STREAM_T", "16")
    jcfg, cfg, lam, rho, stf, sz, sx = _f32_problem(nt=120)
    assert ps._layout(jcfg)[1] >= 4                     # several z-tiles
    rz, rx = ROW[0] + 10, ROW[1] + 10
    jrs = pe.check_row_survey(rz, rx)
    j = lambda a: jnp.asarray(a)
    ref = ps.propagate_pallas_acoustic_streamed(jcfg, jrs, j(lam), j(rho),
                                                j(stf), j(sz), j(sx))
    obs = jnp.asarray(np.asarray(ref) * 1.02)

    def loss(l, r, s):
        d = obs - ps.propagate_pallas_acoustic_streamed(jcfg, jrs, l, r, s,
                                                        j(sz), j(sx))
        return 0.5 * jnp.sum(d * d)

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(j(lam), j(rho), j(stf))
    out, g = _port_f32(cfg, ce.check_row_survey(rz, rx), lam, rho, stf, sz,
                       sx, obs)
    _assert_f32(cfg, out, g, ref, g_ref, STREAM_FWD_TOL, STREAM_GRAD_TOL)
    jax.clear_caches()


def test_wrappers_column_matches_xla_f32():
    jcfg, cfg, lam, rho, stf, sz, sx = _f32_problem()
    rz, rx = COLUMN[0] + 10, COLUMN[1] + 10
    plan = ce.plan_fast_path(cfg, rz, rx)
    assert isinstance(plan.rs, ce.FiberSurvey)
    fwd = _jax_shots(jcfg, _jgeoms(sz, sx, rz, rx))
    j = lambda a: jnp.asarray(a)
    ref = fwd(j(lam), j(rho), j(stf))
    obs = fwd(j(lam) * 1.03, j(rho), j(stf))
    g_ref = jax.grad(lambda l, r, s: 0.5 * jnp.sum((obs - fwd(l, r, s)) ** 2),
                     argnums=(0, 1, 2))(j(lam), j(rho), j(stf))
    out, g = _port_f32(cfg, plan.rs, lam, rho, stf, sz, sx, obs)
    _assert_f32(cfg, out, g, ref, g_ref, PALLAS_FWD_TOL, PALLAS_GRAD_TOL)


def test_acoustic_injection_table_is_the_recording_transpose():
    """The acoustic table gathers, for any cotangent, what scattering the
    three channels of every receiver to its own cell adds."""
    _, cfg = _configs(40, 56, 20, 10)
    fs = ce.make_fiber_survey(POINTS[0] + 10, POINTS[1] + 10)
    ptr, plane, cell, e_rec, e_ch, e_coef = ce._injection_table(
        cfg, fs, acoustic=True)
    rng = np.random.default_rng(11)
    d = rng.standard_normal((3, fs.n_rec))
    want = np.zeros((3, cfg.nz * cfg.nx))
    cells = np.asarray(fs.rec_z) * cfg.nx + np.asarray(fs.rec_x)
    for ch, pl_ in ((0, 0), (1, 2), (2, 1)):   # pr -> p, vx -> vx, vz -> vz
        np.add.at(want[pl_], cells, d[ch])
    got = np.zeros_like(want)
    for t in range(len(plane)):
        for k in range(ptr[t], ptr[t + 1]):
            got[plane[t], cell[t]] += e_coef[k] * d[e_ch[k], e_rec[k]]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert len(plane) == 3 * len(np.unique(cells)) and ptr[-1] == 3 * fs.n_rec


# ---------------------------------------------------------------------------
# rtm_image_time
# ---------------------------------------------------------------------------

def test_rtm_image_time_matches_jax_f64(f64):
    jcfg, cfg, (lam, rho, stf), geoms, args, obs = f64
    vp = np.sqrt(lam / rho)
    syn = tac.propagate_acoustic_ad(cfg, *args)
    res = (obs - syn).numpy()
    one = jac.AcGeom(*(np.asarray(g)[0] for g in geoms))
    img_j, ill_j = jac.rtm_image_time(
        jcfg, jnp.asarray(vp), jnp.asarray(rho), jnp.asarray(stf[0]), one,
        jnp.asarray(res[0]), return_illum=True)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    from sep2023_tpu_torch import imaging
    img, ill = imaging.rtm_image_time(
        cfg, t(vp), t(rho), t(stf[0]),
        convert.acgeom_from_jax(one, device="cpu"), t(res[0]),
        return_illum=True)
    assert np.abs(np.asarray(img_j)).max() > 0
    assert _rel(img.numpy(), img_j) < 1e-10
    assert _rel(ill.numpy(), ill_j) < 1e-10
    only = imaging.rtm_image_time(cfg, t(vp), t(rho), t(stf[0]),
                                  convert.acgeom_from_jax(one, device="cpu"),
                                  t(res[0]))
    assert torch.equal(only, img)
    # both shots at once, and the wrapper's plain version with their sum
    both = tac.rtm_image_time_shots(cfg, t(vp), t(rho), args[2], args[3],
                                    t(res))
    assert torch.equal(both[0][0], img) and torch.equal(both[1][0], ill)


def test_rtm_image_time_locality():
    """tests/test_acoustic.py::test_rtm_image_time_locality on the port:
    the image focuses at a velocity anomaly with one sign there; through
    the wrapper on CPU tensors (float32), which also sums over shots."""
    npml = 10
    _, cfg = _configs(50, 60, 300, npml)
    shape = (cfg.nz, cfg.nx)
    vp_bg = np.full(shape, 3000.0, np.float32)
    az, ax = 42, 40
    vp_tr = vp_bg.copy()
    vp_tr[az - 3:az + 3, ax - 6:ax + 6] += 300.0
    t = torch.from_numpy
    rho = torch.full(shape, 2200.0)
    stf = t(st.ricker(10.0, 300, 0.002).astype(np.float32))[None]
    plan = ce.plan_fast_path(cfg, np.full(40, npml + 3), np.arange(15, 55))
    src = (stf.contiguous(), np.array([npml + 2]), np.array([40]))
    obs = ca.forward_cuda_acoustic_plan(plan, rho * t(vp_tr) ** 2, rho, *src)
    syn = ca.forward_cuda_acoustic_plan(plan, rho * t(vp_bg) ** 2, rho, *src)
    calls = ce.PLAIN_CALLS["rtm_image_time_plain"]
    img, ill = ca.rtm_image_time_cuda_plan(plan, t(vp_bg), rho, *src,
                                           obs - syn, sum_shots=True)
    assert ce.PLAIN_CALLS["rtm_image_time_plain"] == calls + 1
    img, ill = img.numpy(), ill.numpy()
    assert img.shape == shape and np.isfinite(img).all()
    assert np.abs(img).max() > 0 and ill.min() >= 0 and ill.max() > 0
    box = np.zeros(shape, bool)
    box[az - 5:az + 5, ax - 8:ax + 8] = True
    interior = np.zeros(shape, bool)
    interior[npml + 8:-npml - 1, npml + 1:-npml - 1] = True
    near = np.abs(img[box & interior]).mean()
    far = np.abs(img[interior & ~box]).mean()
    assert near > 5.0 * far
    peak = img[az - 3:az + 3, ax - 6:ax + 6]
    dominant = np.sign(peak.ravel()[np.abs(peak).argmax()])
    assert np.sign(peak.sum()) == dominant != 0


# ---------------------------------------------------------------------------
# what the wrappers refuse, and the memory model
# ---------------------------------------------------------------------------

def test_wrappers_raise_off_cpu_and_cuda(monkeypatch):
    """On a device that is neither the CPU nor CUDA every entry reaches the
    kernel library's build (made to fail here) and no plain version."""
    from sep2023_tpu_torch.ops import _build

    def broken_build():
        raise RuntimeError("nvcc failed (simulated)")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA entry point ran a plain version")

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", broken_build)
    for name in ("forward_plain_acoustic", "forward_plain_acoustic_strips",
                 "backward_plain_acoustic", "rtm_image_time_plain"):
        monkeypatch.setattr(ca, name, no_plain)
    _, cfg = _configs(496, 656, 2001, 32)
    plan = ce.plan_fast_path(cfg, np.full(636, 516), np.arange(42, 678))
    meta = lambda *s_: torch.zeros(s_, device="meta")
    src = (np.array([33]), np.array([360]))
    before = (ca.LAUNCHES_AC, ca.LAUNCHES_AC_BWD)
    with pytest.raises(RuntimeError, match="simulated"):
        ca.forward_cuda_acoustic_plan(plan, meta(560, 720), meta(560, 720),
                                      meta(1, 2001), *src)
    with pytest.raises(RuntimeError, match="simulated"):
        ca.propagate_cuda_acoustic_plan(
            plan, meta(560, 720).requires_grad_(), meta(560, 720),
            meta(1, 2001), *src)
    with pytest.raises(RuntimeError, match="simulated"):
        ca.rtm_image_time_cuda_plan(plan, meta(560, 720), meta(560, 720),
                                    meta(1, 2001), *src,
                                    meta(1, 3, 636, 2001))
    assert (ca.LAUNCHES_AC, ca.LAUNCHES_AC_BWD) == before


def test_wrappers_validate_inputs():
    _, cfg = _configs(24, 36, 60, 8)
    plan = ce.plan_fast_path(cfg, np.full(20, 20), np.arange(12, 32))
    lam = torch.full((cfg.nz, cfg.nx), 2.0e10)
    rho = torch.full((cfg.nz, cfg.nx), 2200.0)
    stf = torch.zeros(2, 60)
    src = (np.array([10, 10]), np.array([14, 30]))
    with pytest.raises(NotImplementedError, match="float32"):
        ca.propagate_cuda_acoustic_plan(plan, lam.double(), rho.double(),
                                        stf.double(), *src)
    with pytest.raises(TypeError, match="float32"):
        ca.forward_cuda_acoustic_plan(plan, lam.double(), rho, stf, *src)
    with pytest.raises(ValueError, match="rho must be"):
        ca.forward_cuda_acoustic_plan(plan, lam, rho[:-1], stf, *src)
    with pytest.raises(ValueError, match="stf must be"):
        ca.forward_cuda_acoustic_plan(plan, lam, rho, stf[:, :-1], *src)
    with pytest.raises(ValueError, match="src_x outside"):
        ca.forward_cuda_acoustic_plan(plan, lam, rho, stf, src[0],
                                      np.array([14, cfg.nx]))
    data, strips, final = ca.forward_cuda_acoustic_plan(plan, lam, rho, stf,
                                                        *src,
                                                        save_strips=True)
    assert final.shape == (3, 2, cfg.nz, cfg.nx)
    with pytest.raises(ValueError, match="d_data must be"):
        ca.backward_cuda_acoustic_plan(plan, lam, rho, stf, *src, final,
                                       strips, data[:, :2])
    with pytest.raises(ValueError, match="strips must be"):
        ca.backward_cuda_acoustic_plan(plan, lam, rho, stf, *src, final,
                                       strips[:, :, :2].contiguous(), data)
    with pytest.raises(ValueError, match="residual must be"):
        ca.rtm_image_time_cuda_plan(plan, lam, rho, stf, *src, data[:1])
    # reconstruct_cuda_acoustic_plan is the kernel's alone
    with pytest.raises(RuntimeError):
        ca.reconstruct_cuda_acoustic_plan(plan, lam, rho, stf, *src, final,
                                          strips)


@pytest.mark.parametrize("shape, nt", [((165, 265), 1501),
                                       ((560, 720), 2001),
                                       ((814, 2064), 2001)])
def test_acoustic_memory_model(shape, nt):
    """3 strip fields of 5, and 21 planes (the final fields, the fields
    twice, 9 work planes, 3 gradients) and 3 band planes of CPML memory of
    each axis, as the acoustic wrappers allocate them; auto_shot_chunk
    divides the budget by both."""
    nz, nx = shape
    cfg = tcfg.SimConfig(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=nt, dt=0.001,
                         f0=10.0, npml=32)
    strips = tpar.strip_bytes_per_shot(cfg, acoustic=True)
    planes = tpar.state_bytes_per_shot(cfg, acoustic=True)
    assert strips == (nt - 1) * 3 * 2 * 5 * (nz + nx) * 4
    assert 5 * strips == 3 * tpar.strip_bytes_per_shot(cfg)
    band = 2 * 32 * nx + nz * 2 * 32
    assert planes == ((3 + ca.N_STATE_PLANES + ca.N_WORK_PLANES
                       + ca.N_GRAD_PLANES) * nz * nx
                      + ca.N_BAND_PLANES * band) * 4 \
        == (21 * nz * nx + 3 * band) * 4
    assert tpar.strip_bytes_per_shot(cfg, acoustic=True, itemsize=8) == \
        2 * strips
    per = strips + planes
    assert tpar.auto_shot_chunk(cfg, 64, acoustic=True,
                                budget_bytes=64 * per) == 0
    assert tpar.auto_shot_chunk(cfg, 64, acoustic=True,
                                budget_bytes=10 * per + 1) == 10
    assert tpar.auto_shot_chunk(cfg, 64, acoustic=True, budget_bytes=1) == 1
    # the acoustic chunk is never smaller than the elastic one
    b = 12 * (tpar.strip_bytes_per_shot(cfg) + tpar.state_bytes_per_shot(cfg))
    assert tpar.auto_shot_chunk(cfg, 64, acoustic=True, budget_bytes=b) >= \
        tpar.auto_shot_chunk(cfg, 64, budget_bytes=b) == 12
