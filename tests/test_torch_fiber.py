"""Point-receiver (fiber) recording and its adjoint in the port against the
JAX package, on the CPU, where the port runs its kernels' plain versions.

* `analytic` and `das` are numpy copies: every public function equals the
  original (bitwise, or 1e-15 of the result's max; `apply_gauge`, an
  einsum in another library, 1e-14).
* Planning: the port plans a RowSurvey exactly where the JAX package plans
  an untransposed row, a FiberSurvey elsewhere, None exactly where every
  JAX plan fails for range.
* Forward: 2e-5 of each channel's max against `forward_pallas` on the JAX
  FiberSurvey in interpret mode (float32; exx, ezz, weighted), 1e-12
  against the XLA engine in float64.
* Gradient: 5e-4 of each gradient's max on the interior less 2 cells
  against `jax.grad` through `propagate_pallas` (float32), 1e-12 against
  the XLA engine in float64; the recordings hold arrivals.
* A receiver column (the JAX package's transposed plan) and the
  gauge-averaged misfit, chunked and not, at the same tolerances; a ragged
  union at the bounds of the test it mirrors (gradient 2e-3).
* The backward kernel's injection table is the transpose of the recording.

Inputs are numpy arrays made from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu import analytic as jan
from sep2023_tpu import das as jdas
from sep2023_tpu import parallel as jpar
from sep2023_tpu.config import Survey
from sep2023_tpu.ops import pallas_engine as pe
from sep2023_tpu_torch import analytic as tan
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import convert
from sep2023_tpu_torch import das as tdas
from sep2023_tpu_torch import parallel as tpar
from sep2023_tpu_torch import propagator
from sep2023_tpu_torch.ops import cuda_engine as ce
from sep2023_tpu_torch.testing import FWD_TOL, GRAD_MARGIN, GRAD_TOL

NPML = 10
RNG = np.random.default_rng(11)
CP = np.array([[0.0, 100.0, 0.0], [40.0, 80.0, 0.0], [80.0, 110.0, 0.0],
               [120.0, 90.0, 0.0], [150.0, 100.0, 0.0]])
PTS = RNG.standard_normal((7, 3)).cumsum(axis=0) * 10.0
T_AX = np.linspace(0.0, 0.4, 201)
XYZ = RNG.uniform(100.0, 400.0, (4, 3))
MT = np.array([[1.0, 0.2, 0.0], [0.2, 0.5, 0.1], [0.0, 0.1, 2.0]])
AN_KW = dict(tmin=0.0, tmax=0.3, dt=0.002, f0=15.0, M0=1e16, M=np.eye(3))

# name -> f(das module, analytic module): the same call on both packages
COPIES = {
    "stf_ricker": lambda d, a: a.stf_ricker(T_AX, 12.0, 2.0),
    "stf_ricker_d1": lambda d, a: a.stf_ricker_d1(T_AX, 12.0, 2.0),
    "stf_ricker_d2": lambda d, a: a.stf_ricker_d2(T_AX, 12.0, 2.0),
    "near_field_integral": lambda d, a: a.near_field_integral(
        T_AX, 0.05, 0.09, 12.0, 3.0),
    "moment_tensor": lambda d, a: a.moment_tensor(30.0, 60.0, -45.0),
    "displacement_3d": lambda d, a: a.displacement_3d(
        3000.0, 1700.0, 2500.0, XYZ, T_AX, 12.0, 1e16, MT),
    "displacement_2d": lambda d, a: a.displacement_2d(
        3000.0, 1700.0, 2500.0, 250.0, 200.0, T_AX[:60], 12.0, 1e16, MT),
    "solution_3d_strain": lambda d, a: np.stack(list(a.solution(
        3000.0, 1700.0, 2500.0, 250.0, 30.0, 200.0, dim="3D",
        comp="strain", **AN_KW).values())),
    "solution_3d_velocity": lambda d, a: np.stack(list(a.solution(
        3000.0, 1700.0, 2500.0, 250.0, 30.0, 200.0, dim="3D",
        comp="velocity", **AN_KW).values())),
    "resample_spline": lambda d, a: d.resample_arclength(PTS, 33),
    "resample_linear": lambda d, a: d.resample_arclength(PTS, 33, "linear"),
    "resample_three_knots": lambda d, a: d.resample_arclength(PTS[:3], 9),
    "tangents": lambda d, a: d.tangents(PTS),
    "sensitivity_weights": lambda d, a: d.sensitivity_weights(
        d.tangents(PTS)),
    "arc_fiber": lambda d, a: d.arc_fiber(100.0, 2.0 / np.pi,
                                          center=(350.0, 300.0, 0.0)),
    "arc_fiber_xz": lambda d, a: d.arc_fiber(10.0, 1.0 / np.pi, plane="xz"),
    "straight_fiber": lambda d, a: d.straight_fiber(
        200.0, direction=(1, 1, 0), center=(500.0, 500.0, 0.0)),
    "spline_fiber": lambda d, a: d.spline_fiber(CP),
    "segment_cable": lambda d, a: np.concatenate(
        [np.ravel(v) for v in d.segment_cable(CP, 30.0)]),
    "das_response": lambda d, a: d.das_response(
        3000.0, 1700.0, 2500.0, 10.0,
        d.arc_fiber(10.0, 2.0 / np.pi, center=(250.0, 30.0, 200.0)), 3,
        (0.0, 0.0, 0.0), **AN_KW),
    "cable_to_receivers": lambda d, a: np.concatenate(
        [np.ravel(v).astype(np.float64)
         for v in d.cable_to_receivers(d.spline_fiber(CP), 10.0, 10.0)]),
    "gauge_matrix": lambda d, a: d.gauge_matrix(3, 21, 100.0),
}


@pytest.mark.parametrize("name", list(COPIES))
def test_das_and_analytic_copies_equal_the_originals(name):
    """1e-15 of the result's max (most are bitwise: the same numpy code)."""
    ref = np.asarray(COPIES[name](jdas, jan))
    out = np.asarray(COPIES[name](tdas, tan))
    assert out.shape == ref.shape and np.abs(ref).max() > 0
    assert np.abs(out - ref).max() <= 1e-15 * np.abs(ref).max()


def test_apply_gauge_takes_a_tensor():
    """The one function of the copy that differs: numpy or torch in, the
    same out; 1e-14 of the max against jnp.einsum, whose sum over the 21
    points runs in another order."""
    A = tdas.gauge_matrix(2, 21, 10.0)
    x = RNG.standard_normal((3, 42, 8))
    ref = np.asarray(jdas.apply_gauge(jnp.asarray(x), A))
    out = tdas.apply_gauge(torch.from_numpy(x).requires_grad_(), A)
    assert isinstance(out, torch.Tensor) and out.requires_grad
    out_np = tdas.apply_gauge(x, A)
    assert isinstance(out_np, np.ndarray)
    for o in (out.detach().numpy(), out_np):
        assert np.abs(o - ref).max() <= 1e-14 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# Problems
# ---------------------------------------------------------------------------

def _cfgs(das_channel, dh=10.0, dt=0.001, f0=15.0, nt=120, nz=40, nx=56):
    kw = dict(nz=nz + 2 * NPML, nx=nx + 2 * NPML, dz=dh, dx=dh, nt=nt, dt=dt,
              f0=f0, npml=NPML, das_channel=das_channel)
    return st.SimConfig(**kw), tcfg.SimConfig(**kw)


def _model(cfg, seed=5):
    """Random model around 3000 m/s with a fast box, as numpy float64
    (lam, mu, rho)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.nz, cfg.nx)
    vp = 3000.0 + 40.0 * rng.standard_normal(shape)
    vp[26:32, 30:44] += 220.0
    vs = vp / np.sqrt(3.0)
    rho = 2500.0 + 15.0 * rng.standard_normal(shape)
    return (vp ** 2 - 2.0 * vs ** 2) * rho, vs ** 2 * rho, rho


def _arc_survey(cfg):
    """The arc fiber of tests/test_pallas_engine.py:239 (21 points over 3
    rows, lanes visited twice) under 2 shots, with a moment ratio."""
    cable = jdas.arc_fiber(80.0, 2.0 / np.pi, center=(260.0, 200.0, 0.0))
    rec_z, rec_x, das_w = jdas.cable_to_receivers(cable, cfg.dx, cfg.dz)
    survey = Survey(src_z=np.array([2, 2]), src_x=np.array([14, 40]),
                    rec_z=rec_z, rec_x=rec_x, src_rxz=np.array([1.0, 1.5]))
    return survey, das_w


def _stf(cfg, n):
    return np.stack([(1.0 - 0.3 * i) * st.ricker(cfg.f0, cfg.nt, cfg.dt)
                     for i in range(n)])


def _f32(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in arrays)


def _jf32(*arrays):
    return tuple(jnp.asarray(a, jnp.float32) for a in arrays)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _assert_data_close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    for c in range(4):
        assert _rel(out[:, c], ref[:, c]) < tol, (c, _rel(out[:, c],
                                                         ref[:, c]))


def _assert_grads_close(cfg, out, ref, tol):
    m = cfg.npml + GRAD_MARGIN
    sl = (slice(m, cfg.nz - m), slice(m, cfg.nx - m))
    for name, a, b in zip(("lam", "mu", "rho", "stf"), out, ref):
        a, b = np.asarray(a), np.asarray(b)
        if name != "stf":
            a, b = a[sl], b[sl]
        assert np.abs(b).max() > 0
        assert _rel(a, b) < tol, (name, _rel(a, b))


def _assert_arrivals(data):
    """The receivers saw the wave: ett far above the noise of the quiet
    first samples (a gradient test without arrivals compares round-off)."""
    ett = np.abs(np.asarray(data)[:, 3])
    assert ett.max() > 1e-3 and ett[..., :8].max() < 1e-6 * ett.max()


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

def _plan_surveys():
    jcfg, _ = _cfgs("exx", dh=20.0)
    arc, arc_w = _arc_survey(_cfgs("weighted")[0])
    zz, xx = np.meshgrid(np.arange(22, 28), np.arange(14, 24), indexing="ij")
    ragged = np.unique(np.stack([
        np.array([30] * 16 + [32] * 16),
        np.array(list(range(14, 26)) + [25] * 4 + list(range(18, 34)))],
        axis=1), axis=0)
    n = NPML
    return {
        # tests/test_pallas_engine.py:192, a receiver row
        "row": ("exx", np.full(20, 32) + n, np.arange(16, 36) + n, None),
        "row_ezz": ("ezz", np.full(20, 32) + n, np.arange(16, 36) + n, None),
        # :215, a borehole column: the JAX package transposes it
        "column": ("exx", np.arange(8, 34) + n, np.full(26, 48) + n, None),
        # :239-256, the weighted arc fiber
        "arc_weighted": ("weighted", arc.rec_z + n, arc.rec_x + n, arc_w),
        # :511, a dense areal grid: 6 layers, past the JAX default of 4
        "areal": ("exx", zz.ravel() + n, xx.ravel() + n, None),
        # tests/test_ragged.py:126, the union of two ragged spreads
        "ragged_union": ("exx", ragged[:, 0] + n, ragged[:, 1] + n, None),
        # a row with weights plans as a fiber in both
        "row_weighted": ("weighted", np.full(6, 32) + n, np.arange(16, 22) + n,
                         np.tile([1.0, 0.0, 0.0], (6, 1))),
        # a row on the grid's first row: only the transposed range takes it
        "row_z0": ("exx", np.zeros(5, int), np.arange(20, 25), None),
        # outside both ranges: z = 0 together with x = 0
        "corner": ("exx", np.array([0, 12]), np.array([0, 12]), None),
        "below": ("exx", np.full(4, jcfg.nz - 1), np.array([0, 1, 2, 3]),
                  None),
    }


@pytest.mark.parametrize("name", list(_plan_surveys()))
def test_plan_matches_jax(name):
    ch, rz, rx, w = _plan_surveys()[name]
    jcfg, cfg = _cfgs(ch)
    jplan = pe.plan_fast_path(jcfg, rz, rx, das_w=w)
    # with the layer cap lifted, only the range can refuse a JAX plan
    jplan_any = pe.plan_fast_path(jcfg, rz, rx, das_w=w, max_layers=10 ** 6)
    plan = ce.plan_fast_path(cfg, rz, rx, das_w=w)
    assert (plan is None) == (jplan_any is None)
    if plan is None:
        with pytest.raises(ValueError, match="recordable range"):
            ce.plan_for(cfg, ce.make_fiber_survey(rz, rx, w))
        return
    jax_row = (jplan is not None and not jplan.transposed
               and isinstance(jplan.rs, pe.RowSurvey))
    if jax_row:
        assert plan.rs == ce.RowSurvey(*jplan.rs)
    else:
        assert plan.rs == ce.make_fiber_survey(rz, rx, w)
        assert plan.rs.rec_z == tuple(rz) and plan.rs.rec_x == tuple(rx)
    assert ce.plan_fast_path(cfg, rz, rx, das_w=w) is plan  # cached
    assert ("point receivers" in ce.plan_engine_name(plan)) == (not jax_row)


def test_plan_builds_its_device_tables_once():
    """The receiver tables and each distinct source set are validated and
    uploaded once per (plan, device): a second call returns the same
    tensors; sources off the grid raise before any upload."""
    _, cfg = _cfgs("weighted")
    rz, rx = np.array([20, 21, 22]), np.array([30, 31, 31])
    plan = ce.FastPlan(cfg, ce.make_fiber_survey(rz, rx, np.ones((3, 3))))
    cpu = torch.device("cpu")
    rec = plan.receivers(cpu)
    assert plan.receivers(cpu) is rec
    assert rec[0].tolist() == [20, 21, 22] and rec[2].shape == (3, 3)
    src = plan.sources(cpu, 2, [5, 6], np.array([7, 8]), torch.ones(2))
    assert [t.dtype for t in src] == [torch.int32, torch.int32,
                                      torch.float32]
    assert src[1].tolist() == [7, 8]
    assert plan.sources(cpu, 2, np.array([5, 6]), [7, 8], [1.0, 1.0]) is src
    assert plan.sources(cpu, 2, [5, 6], [7, 9], [1.0, 1.0]) is not src
    with pytest.raises(ValueError, match="src_x outside"):
        plan.sources(cpu, 2, [5, 6], [7, cfg.nx], [1.0, 1.0])
    with pytest.raises(ValueError, match=r"src_z must be \(3,\)"):
        plan.sources(cpu, 3, [5, 6], [7, 8], [1.0, 1.0])


def test_jax_fiber_survey_converts_in_the_callers_order():
    """convert.fiber_survey_from_jax(JAX FiberSurvey) is the FiberSurvey the
    port plans from the same arrays: receiver order is the caller's in
    both, so data compare without a permutation."""
    jcfg, cfg = _cfgs("weighted")
    survey, das_w = _arc_survey(jcfg)
    (rz, rx, w), (sz, sx, rxz) = convert.plan_inputs(cfg, survey, das_w)
    jfs = pe.plan_fast_path(jcfg, rz, rx, das_w=w).rs
    assert isinstance(jfs, pe.FiberSurvey) and jfs.n_layers >= 2
    assert convert.fiber_survey_from_jax(jfs) == \
        ce.plan_fast_path(cfg, rz, rx, das_w=w).rs
    sv = convert.survey_from_jax(survey)
    assert isinstance(sv, tcfg.Survey)
    np.testing.assert_array_equal(sv.rec_z + NPML, rz)
    np.testing.assert_array_equal(sv.src_x + NPML, sx)
    np.testing.assert_array_equal(sv.src_rxz, rxz)


# ---------------------------------------------------------------------------
# The injection table against autograd of the recording
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("das_channel", ["exx", "ezz", "weighted"])
def test_injection_table_is_the_recording_transpose(das_channel):
    """The backward kernel's gather table (plane, cell) <- (receiver,
    channel, coefficient), applied to a random data cotangent, equals
    autograd of propagator._record: 1e-6 of the max (float32 coefficients
    against float64 autograd).  Duplicate and overlapping receivers."""
    _, cfg = _cfgs(das_channel)
    rz = np.array([20, 20, 21, 21, 20, 1, cfg.nz - 2, 30])
    rx = np.array([30, 31, 31, 31, 30, 0, cfg.nx - 1, 40])
    w = RNG.standard_normal((len(rz), 3))
    fs = ce.make_fiber_survey(rz, rx, w)
    ptr, plane, cell, e_rec, e_ch, e_coef = ce._injection_table(cfg, fs)
    d = RNG.standard_normal((4, len(rz)))
    out = np.zeros((4, cfg.nz * cfg.nx))
    for t in range(len(plane)):
        j = slice(ptr[t], ptr[t + 1])
        out[plane[t], cell[t]] += (e_coef[j] * d[e_ch[j], e_rec[j]]).sum()
    assert (np.diff(plane.astype(np.int64) * cfg.nz * cfg.nx + cell) > 0
            ).all()                                   # sorted, unique rows

    f = propagator.Fields(*(torch.zeros(1, cfg.nz, cfg.nx,
                                        dtype=torch.float64).requires_grad_()
                            for _ in range(5)))
    geom = ce._geoms(cfg, fs, [5], [5], [1.0], "cpu", torch.float64)
    rec = propagator._record(f, geom, cfg)
    g = torch.autograd.grad(rec, (f.vz, f.vx, f.szz, f.sxx),
                            torch.from_numpy(d)[None])
    ref = np.stack([a.numpy().reshape(-1) for a in g])
    # a neighbour off the grid wraps in the plain version (x-1 = -1 of the
    # receiver at (1, 0), x+1 = nx of the one at (nz-2, nx-1)) and is
    # dropped by the table: it lies outside the update mask, where the
    # field is 0 and nothing reads its cotangent
    keep = np.ones((cfg.nz, cfg.nx), bool)
    keep[1, cfg.nx - 1] = keep[cfg.nz - 2, 0] = False
    keep = keep.reshape(-1)
    assert np.abs(ref).max() > 0
    assert np.abs(out - ref)[:, keep].max() < 1e-6 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# Forward and gradient on the arc fiber
# ---------------------------------------------------------------------------

def _jax_geoms(jcfg, survey, das_w, dtype):
    S, R = survey.n_shots, survey.n_rec
    idx = lambda a: jnp.asarray(a + jcfg.npml, jnp.int32)
    return st.ShotGeom(
        src_z=idx(survey.src_z), src_x=idx(survey.src_x),
        rxz=jnp.asarray(survey.src_rxz, dtype),
        rec_z=jnp.broadcast_to(idx(survey.rec_z), (S, R)),
        rec_x=jnp.broadcast_to(idx(survey.rec_x), (S, R)),
        das_w=(None if das_w is None else
               jnp.broadcast_to(jnp.asarray(das_w, dtype), (S, R, 3))))


@pytest.mark.parametrize("das_channel", ["exx", "ezz", "weighted"])
def test_fiber_forward_matches_pallas_and_xla(das_channel):
    jcfg, cfg = _cfgs(das_channel)
    survey, das_w = _arc_survey(jcfg)
    if das_channel != "weighted":
        das_w = None
    mats, stf = _model(cfg), _stf(cfg, 2)
    (rz, rx, w), src = convert.plan_inputs(cfg, survey, das_w)
    jplan = pe.plan_fast_path(jcfg, rz, rx, das_w=w)
    plan = ce.plan_fast_path(cfg, rz, rx, das_w=w)
    assert isinstance(jplan.rs, pe.FiberSurvey) and not jplan.transposed
    assert isinstance(plan.rs, ce.FiberSurvey)

    # float32: the plain version against the Pallas kernel (interpret mode)
    ref = np.asarray(pe.forward_pallas(jcfg, jplan.rs, *_jf32(*mats, stf),
                                       *src))
    calls = ce.PLAIN_CALLS["forward_plain"]
    out = ce.forward_cuda_plan(plan, *_f32(*mats, stf), *src)
    assert ce.PLAIN_CALLS["forward_plain"] == calls + 1
    _assert_arrivals(ref)
    _assert_data_close(out.numpy(), ref, FWD_TOL)

    # float64: the plain version against the XLA engine
    geoms = _jax_geoms(jcfg, survey, das_w, jnp.float64)
    ref64 = jax.vmap(lambda s, g: st.propagate(jcfg, *mats, s, g))(
        jnp.asarray(stf), geoms)
    out64 = ce.forward_plain(cfg, plan.rs, *(torch.from_numpy(a) for a in
                                             (*mats, stf)), *src)
    _assert_data_close(out64.numpy(), ref64, 1e-12)


@pytest.fixture(scope="module")
def arc_gradient():
    """The weighted arc fiber's L2 gradient three ways."""
    jcfg, cfg = _cfgs("weighted")
    survey, das_w = _arc_survey(jcfg)
    mats, stf = _model(cfg), _stf(cfg, 2)
    (rz, rx, w), src = convert.plan_inputs(cfg, survey, das_w)
    jplan = pe.plan_fast_path(jcfg, rz, rx, das_w=w)
    plan = ce.plan_fast_path(cfg, rz, rx, das_w=w)
    return jcfg, cfg, survey, das_w, mats, stf, src, jplan, plan


def test_fiber_gradient_matches_pallas(arc_gradient):
    jcfg, cfg, _, _, mats, stf, src, jplan, plan = arc_gradient
    jsrc = tuple(jnp.asarray(a) for a in src)
    lam, mu, rho, stf_j = _jf32(*mats, stf)
    obs = pe.forward_pallas(jcfg, jplan.rs, lam * 1.03, mu, rho, stf_j, *src)
    _assert_arrivals(obs)

    def loss_j(l, m, r, s):
        syn = pe.propagate_pallas(jcfg, jplan.rs, l, m, r, s, *jsrc)
        res = (obs - syn)[:, 3]
        return 0.5 * jnp.sum(res * res)

    val_j, g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3))(
        lam, mu, rho, stf_j)

    ps = [a.requires_grad_() for a in _f32(*mats, stf)]
    calls = dict(ce.PLAIN_CALLS)
    syn = ce.propagate_cuda_plan(plan, *ps, *src)
    res = (torch.from_numpy(np.array(obs)) - syn)[:, 3]
    val = 0.5 * (res * res).sum()
    g = torch.autograd.grad(val, ps)
    assert ce.PLAIN_CALLS["forward_plain_strips"] == \
        calls["forward_plain_strips"] + 1
    assert ce.PLAIN_CALLS["backward_plain"] == calls["backward_plain"] + 1
    assert float(val) == pytest.approx(float(val_j), rel=1e-4)
    _assert_grads_close(cfg, [a.numpy() for a in g], g_j, GRAD_TOL)


def test_fiber_gradient_matches_xla_f64(arc_gradient):
    jcfg, cfg, survey, das_w, mats, stf, src, _, plan = arc_gradient
    geoms = _jax_geoms(jcfg, survey, das_w, jnp.float64)
    fwd = lambda l, m, r, s: jax.vmap(
        lambda si, g: st.propagate(jcfg, l, m, r, si, g))(s, geoms)
    obs = fwd(mats[0] * 1.03, mats[1], mats[2], jnp.asarray(stf))

    def loss_j(l, m, r, s):
        res = (obs - fwd(l, m, r, s))[:, 3]
        return 0.5 * jnp.sum(res * res)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (*mats, stf)))
    ps = [torch.from_numpy(a).requires_grad_() for a in (*mats, stf)]
    tg = ce._geoms(cfg, plan.rs, *src, "cpu", torch.float64)
    syn = propagator.propagate_shots(cfg, *ps, tg)
    res = (torch.from_numpy(np.array(obs)) - syn)[:, 3]
    g = torch.autograd.grad(0.5 * (res * res).sum(), ps)
    for name, a, b in zip(("lam", "mu", "rho", "stf"), g, g_j):
        assert _rel(a.numpy(), b) < 1e-12, (name, _rel(a.numpy(), b))


# ---------------------------------------------------------------------------
# A receiver column: JAX transposes the grid, the port records points
# ---------------------------------------------------------------------------

def test_column_survey_equals_the_transposed_plan():
    """tests/test_pallas_engine.py:215 (dz != dx, moment ratios 1 and 3):
    data (channels in the original order) and the lam gradient."""
    jcfg, cfg = _cfgs("exx", dt=0.002, f0=10.0)
    kw = dict(dz=20.0, dx=10.0)
    jcfg = st.SimConfig(**{**jcfg.__dict__, **kw})
    cfg = tcfg.SimConfig(**{**cfg.__dict__, **kw})
    survey = Survey(src_z=np.array([6, 20]), src_x=np.array([6, 6]),
                    rec_z=np.arange(8, 34), rec_x=np.full(26, 48),
                    src_rxz=np.array([1.0, 3.0]))
    mats, stf = _model(cfg), _stf(cfg, 2)
    (rz, rx, _), src = convert.plan_inputs(cfg, survey)
    jplan = pe.plan_fast_path(jcfg, rz, rx)
    plan = ce.plan_fast_path(cfg, rz, rx)
    assert jplan.transposed and isinstance(jplan.rs, pe.RowSurvey)
    assert isinstance(plan.rs, ce.FiberSurvey)
    jsrc = tuple(jnp.asarray(a) for a in src)
    lam, mu, rho, stf_j = _jf32(*mats, stf)
    obs = pe.propagate_pallas_plan(jplan, lam * 1.03, mu, rho, stf_j, *jsrc)

    def loss_j(l):
        syn = pe.propagate_pallas_plan(jplan, l, mu, rho, stf_j, *jsrc)
        return 0.5 * jnp.sum((obs - syn)[:, 3] ** 2), syn

    (_, ref), g_j = jax.value_and_grad(loss_j, has_aux=True)(lam)
    _assert_arrivals(ref)

    tl, tm, tr, ts = _f32(*mats, stf)
    tl.requires_grad_()
    syn = ce.propagate_cuda_plan(plan, tl, tm, tr, ts, *src)
    _assert_data_close(syn.detach().numpy(), ref, FWD_TOL)
    res = (torch.from_numpy(np.array(obs)) - syn)[:, 3]
    (g,) = torch.autograd.grad(0.5 * (res * res).sum(), tl)
    _assert_grads_close(cfg, [g.numpy()], [g_j], GRAD_TOL)


# ---------------------------------------------------------------------------
# Ragged union and the gauge misfit through make_cuda_misfit
# ---------------------------------------------------------------------------

def _live_l2(lib):
    """Per-shot L2 on ett with per-trace weights (the ragged live mask)."""
    return lambda o, s, tw: 0.5 * lib.sum(tw[:, None] * (o[3] - s[3]) ** 2)


def test_ragged_union_matches_pallas():
    """Mirror of tests/test_ragged.py:126: the kernels record the union of
    the spreads, each shot gathers its own; against make_pallas_misfit
    with the same per-shot misfit, value 1e-5 and lam gradient 2e-3 of its
    max, the bound of the test it mirrors: the observed data come from a
    model 2% off, so the residual is small and the float32 round-off of
    the two forwards weighs more in this gradient than in the others."""
    jcfg, cfg = _cfgs("exx", dh=20.0, dt=0.002, f0=10.0, nt=100)
    spread = dict(
        src_z=np.array([2, 2]), src_x=np.array([14, 40]),
        rec_z=np.array([[30] * 12 + [30] * 4, [32] * 16]),
        rec_x=np.array([list(range(14, 26)) + [25] * 4, list(range(18, 34))]),
        rec_live=np.array([[1.0] * 12 + [0.0] * 4, [1.0] * 16]))
    jsv, sv = Survey(**spread), tcfg.Survey(**spread)
    assert sv.ragged
    mats, stf = _model(cfg), _stf(cfg, 2)
    tw = sv.live_trace_weights().astype(np.float32)
    plan, uidx = tpar._cuda_plan(cfg, sv)
    assert isinstance(plan.rs, ce.FiberSurvey) and plan.rs.n_rec == 28
    assert uidx.shape == (2, 16)

    fwd = tpar.make_forward(cfg, sv, use_kernels=True, device="cpu")
    obs = fwd(*_f32(mats[0] * 1.02, mats[1], mats[2], stf))
    assert obs.shape == (2, 4, 16, cfg.nt)
    _assert_arrivals(obs.numpy())

    lam, mu, rho, stf_j = _jf32(*mats, stf)
    loss_j = jpar.make_pallas_misfit(jcfg, jsv, misfit_fn=_live_l2(jnp))
    val_j, g_j = jax.value_and_grad(loss_j)(
        lam, mu, rho, stf_j, jnp.asarray(obs.numpy()),
        jnp.ones(2, jnp.float32), jnp.asarray(tw))

    tl, tm, tr, ts = _f32(*mats, stf)
    tl.requires_grad_()
    loss = tpar.make_cuda_misfit(cfg, sv, misfit_fn=_live_l2(torch))
    val = loss(tl, tm, tr, ts, obs, torch.ones(2), torch.from_numpy(tw))
    (g,) = torch.autograd.grad(val, tl)
    assert float(val) > 0
    assert float(val) == pytest.approx(float(val_j), rel=1e-5)
    _assert_grads_close(cfg, [g.numpy()], [g_j], 2e-3)
    with pytest.raises(ValueError, match="ragged"):
        tpar._cuda_plan(cfg, sv, das_w=np.ones((16, 3)))


def test_gauge_misfit_matches_pallas(arc_gradient):
    """make_cuda_misfit(misfit_fn=gauge_l2, das_w=...) against
    make_pallas_misfit with the same arguments (the chain of
    tests/test_das.py:160): value 1e-5, gradients 5e-4; shot-chunked equal
    to unchunked to 1e-6."""
    jcfg, cfg, survey, das_w, mats, stf, _, _, _ = arc_gradient
    A = tdas.gauge_matrix(1, tdas.N_CABLE_PTS, 80.0).astype(np.float32)
    sv = convert.survey_from_jax(survey)
    fwd = tpar.make_forward(cfg, sv, use_kernels=True, device="cpu",
                            das_w=das_w)
    obs = fwd(*_f32(mats[0] * 1.03, mats[1], mats[2], stf))
    obs_g = tdas.apply_gauge(obs[:, 3], A)
    assert obs_g.shape == (2, 1, cfg.nt) and float(obs_g.abs().max()) > 1e-3

    def gauge_j(o, s):
        r = o - jdas.apply_gauge(s[3], jnp.asarray(A))
        return 0.5 * jnp.sum(r * r)

    def gauge_t(o, s):
        r = o - tdas.apply_gauge(s[3], A)
        return 0.5 * torch.sum(r * r)

    loss_j = jpar.make_pallas_misfit(jcfg, survey, misfit_fn=gauge_j,
                                     das_w=das_w)
    w = np.array([1.0, 0.5], np.float32)
    val_j, g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3))(
        *_jf32(*mats, stf), jnp.asarray(obs_g.numpy()), jnp.asarray(w))

    def port(chunk):
        ps = [a.requires_grad_() for a in _f32(*mats, stf)]
        loss = tpar.make_cuda_misfit(cfg, sv, misfit_fn=gauge_t,
                                     das_w=das_w, shot_chunk=chunk)
        val = loss(*ps, obs_g, torch.from_numpy(w))
        return float(val), [g.numpy() for g in torch.autograd.grad(val, ps)]

    val, g = port(0)
    assert val > 0 and val == pytest.approx(float(val_j), rel=1e-5)
    _assert_grads_close(cfg, g, g_j, GRAD_TOL)
    val_c, g_c = port(1)
    assert val_c == pytest.approx(val, rel=1e-6)
    for a, b in zip(g_c, g):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


# ---------------------------------------------------------------------------
# ElasticPropagator takes the surveys it raised for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["column", "ragged"])
def test_api_takes_column_and_ragged_surveys(layout):
    """apply_forward and apply_gradient through the plan (plain versions on
    the CPU) equal the plain propagator on the same survey: 2e-5 and 5e-4."""
    from sep2023_tpu_torch import api

    nz, nx = 36, 52
    vp = np.full((nz, nx), 3000.0)
    vp[20:28, 20:36] += 250.0
    model = api.Model(nx=nx, nz=nz, dx=20.0, dz=20.0, nt=150, dt=0.002,
                      nPml=NPML, vp=vp, vs=vp / np.sqrt(3.0),
                      rho=np.full((nz, nx), 2500.0))
    sv = dict(src_z=np.array([2, 2]), src_x=np.array([12, 40]))
    if layout == "column":
        sv.update(rec_z=np.arange(8, 30), rec_x=np.full(22, 26))
    else:
        sv.update(rec_z=np.stack([np.full(20, 16), np.full(20, 18)]),
                  rec_x=np.stack([np.arange(14, 34), np.arange(15, 35)]))
    survey = tcfg.Survey(**sv)
    prop = api.ElasticPropagator(model, survey, device="cpu")
    assert isinstance(prop.rs, ce.FiberSurvey)
    data = prop.apply_forward()
    geoms = tpar.survey_to_geoms(survey, NPML, device="cpu")
    ref = propagator.propagate_shots(prop.cfg, *prop._padded(
        model.vp, model.vs, model.rho), prop.stf, geoms).numpy()
    _assert_arrivals(ref)
    _assert_data_close(data, ref, FWD_TOL)

    init = api.Model(**{**model.__dict__, "vp": np.full((nz, nx), 3000.0)})
    calls = ce.PLAIN_CALLS["backward_plain"]
    out = prop.apply_gradient(init, data)
    assert ce.PLAIN_CALLS["backward_plain"] == calls + 1
    plain = api.ElasticPropagator(model, survey, device="cpu")
    plain.rs = None                     # the plain propagator's own path
    ref_g = plain.apply_gradient(init, data)
    assert out["misfit"] > 0
    assert out["misfit"] == pytest.approx(ref_g["misfit"], rel=1e-5)
    for k in ("grad_vp", "grad_vs", "grad_rho", "grad_stf"):
        assert _rel(out[k], ref_g[k]) < GRAD_TOL, k
