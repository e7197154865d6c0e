"""The port against the JAX package's streamed engine (ops/pallas_stream.py,
the pair that runs grids past the TPU's memory gate), on the CPU.

The port has no streamed engine of its own: its kernels keep all state in
device memory, so one pair runs every grid size, and on the CPU its plain
versions stand in for them.  These tests hold that the streamed pair
computes nothing the port does not:

* With SEP2023_TPU_STREAM_T=16 (several z-tiles, as tests/
  test_pallas_stream.py forces) the port's forward and gradient equal
  `propagate_pallas_streamed` in interpret mode, on a receiver row and on
  the weighted curved fiber, at that file's own tolerances: 3e-5 of each
  channel's max for the data, 5e-4 of each gradient's max (float32 both).
  nt - 1 = 119 is no multiple of the streamed engine's sub-steps a launch
  (K = 3, 2 in the backward), so its zero-amplitude ghost steps run; the
  port runs exactly nt - 1 steps, and the data show no difference.
* Dispatch: a weighted fiber at 560x720 reaches the kernel wrapper on a
  device that is not the CPU (the receiver rows at 165x265 to 814x2064 are
  in tests/test_torch_gradient.py).
* `auto_shot_chunk` counts the state planes beside the strips on the three
  grids of the large-grid runs.

Inputs are numpy arrays made from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu import das as jdas
from sep2023_tpu.ops import pallas_engine as pe
from sep2023_tpu.ops import pallas_stream as ps
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import das as tdas
from sep2023_tpu_torch import parallel as tpar
from sep2023_tpu_torch.ops import cuda_engine as ce

NPML = 10
STREAM_FWD_TOL = 3e-5   # tests/test_pallas_stream.py:85,145
STREAM_GRAD_TOL = 5e-4  # tests/test_pallas_stream.py:104,163


@pytest.fixture(autouse=True)
def _small_tiles(monkeypatch):
    monkeypatch.setenv("SEP2023_TPU_STREAM_T", "16")


@pytest.fixture(autouse=True)
def _free_compiled_programs():
    """As tests/test_pallas_stream.py: drop the large streamed-scan
    programs after each test."""
    yield
    jax.clear_caches()


def _problem(das_channel, dh, dt, f0, nz, nx, seed=3):
    """Both packages' configs and a seeded model (a fast box in a slightly
    random background), numpy float32 (lam, mu, rho) and 2 wavelets."""
    kw = dict(nz=nz + 2 * NPML, nx=nx + 2 * NPML, dz=dh, dx=dh, nt=120,
              dt=dt, f0=f0, npml=NPML, das_channel=das_channel)
    jcfg, cfg = st.SimConfig(**kw), tcfg.SimConfig(**kw)
    assert (cfg.nt - 1) % 6 != 0
    rng = np.random.default_rng(seed)
    vp = 3000.0 + 20.0 * rng.standard_normal((cfg.nz, cfg.nx))
    vp[26:32, 30:44] += 220.0
    vs = vp / np.sqrt(3.0)
    rho = np.full_like(vp, 2500.0)
    mats = tuple(a.astype(np.float32) for a in
                 ((vp ** 2 - 2 * vs ** 2) * rho, vs ** 2 * rho, rho))
    stf = np.stack([st.ricker(f0, cfg.nt, dt), 0.7 * st.ricker(f0, cfg.nt, dt)]
                   ).astype(np.float32)
    return jcfg, cfg, mats, stf


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _compare(jcfg, jrs, plan, mats, stf, src, wrt, perturbed):
    """Data and the gradients of 0.5 |obs - syn|^2 on ett with respect to
    the first `wrt` of (lam, mu, rho, stf): the streamed engine against the
    port's plan propagator on CPU tensors.  obs is the data of the model
    with lam raised by 3% and mu lowered by 2% (`perturbed`), or the data
    times 1.01, as in the tests mirrored."""
    assert ps._layout(jcfg)[1] >= 4                     # several z-tiles
    jsrc = tuple(jnp.asarray(a) for a in src)
    jargs = tuple(jnp.asarray(a) for a in (*mats, stf))
    ref = ps.propagate_pallas_streamed(jcfg, jrs, *jargs, *jsrc)
    if perturbed:
        obs = np.asarray(ps.propagate_pallas_streamed(
            jcfg, jrs, jargs[0] * 1.03, jargs[1] * 0.98, *jargs[2:], *jsrc))
    else:
        obs = np.asarray(ref) * 1.01
    ett = np.abs(obs[:, 3])
    assert ett.max() > 1e-3 and ett[..., :8].max() < 1e-6 * ett.max()

    def loss_j(*p):
        syn = ps.propagate_pallas_streamed(jcfg, jrs, *p, *jargs[len(p):],
                                           *jsrc)
        r = (jnp.asarray(obs) - syn)[:, 3]
        return 0.5 * jnp.sum(r * r)

    g_j = jax.grad(loss_j, argnums=tuple(range(wrt)))(*jargs[:wrt])

    ps_t = [torch.from_numpy(a.copy()) for a in (*mats, stf)]
    for p in ps_t[:wrt]:
        p.requires_grad_()
    calls = dict(ce.PLAIN_CALLS)
    syn = ce.propagate_cuda_plan(plan, *ps_t, *src)
    r = (torch.from_numpy(obs) - syn)[:, 3]
    g = torch.autograd.grad(0.5 * (r * r).sum(), ps_t[:wrt])
    assert ce.PLAIN_CALLS["forward_plain_strips"] == \
        calls["forward_plain_strips"] + 1
    assert ce.PLAIN_CALLS["backward_plain"] == calls["backward_plain"] + 1
    out = syn.detach().numpy()
    assert out.shape == ref.shape
    for c in range(4):
        assert _rel(out[:, c], np.asarray(ref)[:, c]) < STREAM_FWD_TOL, c
    for k, (a, b) in enumerate(zip(g, g_j)):
        assert np.abs(np.asarray(b)).max() > 0
        assert _rel(a.numpy(), b) < STREAM_GRAD_TOL, (k, _rel(a.numpy(), b))


def test_plain_matches_streamed_row_survey():
    """tests/test_pallas_stream.py:63: a receiver row across 4 z-tiles,
    data and the gradients of lam, mu, rho and stf."""
    jcfg, cfg, mats, stf = _problem("exx", 20.0, 0.002, 10.0, 44, 60)
    rz, rx = np.full(24, 38) + NPML, np.arange(16, 40) + NPML
    src = (np.array([2, 30]) + NPML, np.array([14, 40]) + NPML,
           np.array([1.0, 1.5], np.float32))
    jrs = pe.check_row_survey(rz, rx)
    plan = ce.plan_fast_path(cfg, rz, rx)
    assert plan.rs == ce.RowSurvey(*jrs)
    _compare(jcfg, jrs, plan, mats, stf, src, wrt=4, perturbed=True)


def test_plain_matches_streamed_weighted_curved_fiber():
    """tests/test_pallas_stream.py:107: the weighted arc fiber (a K-layer
    FiberSurvey there, point receivers here), data and the lam gradient."""
    jcfg, cfg, mats, stf = _problem("weighted", 10.0, 0.001, 15.0, 40, 56)
    cable = jdas.arc_fiber(80.0, 2.0 / np.pi, center=(260.0, 200.0, 0.0))
    rec_z, rec_x, das_w = jdas.cable_to_receivers(cable, cfg.dx, cfg.dz)
    rz, rx = rec_z + NPML, rec_x + NPML
    src = (np.array([2, 2]) + NPML, np.array([14, 40]) + NPML,
           np.ones(2, np.float32))
    jplan = pe.plan_fast_path(jcfg, rz, rx, das_w=das_w)
    assert isinstance(jplan.rs, pe.FiberSurvey) and jplan.rs.n_layers >= 2
    plan = ce.plan_fast_path(cfg, rz, rx, das_w=das_w)
    assert isinstance(plan.rs, ce.FiberSurvey)
    _compare(jcfg, jplan.rs, plan, mats, stf, src, wrt=1,
             perturbed=False)


def test_weighted_fiber_at_560x720_reaches_the_kernel_wrapper(monkeypatch):
    """A weighted spline fiber on the 560x720 grid, on a device that is not
    the CPU: the gradient reaches the kernel build (made to fail here)
    with the plan's receiver and injection tables made, and no plain
    version runs."""
    from sep2023_tpu_torch.ops import _build

    def broken_build():
        raise RuntimeError("nvcc failed (simulated)")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA entry point ran a plain version")

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", broken_build)
    for name in ("forward_plain", "forward_plain_strips", "backward_plain"):
        monkeypatch.setattr(ce, name, no_plain)
    nz, nx = 560, 720
    cfg = tcfg.SimConfig(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=1001, dt=0.001,
                         f0=10.0, npml=32, das_channel="weighted")
    cp = np.array([[500.0, 3200.0, 0.0], [2000.0, 3600.0, 0.0],
                   [3500.0, 3000.0, 0.0], [5000.0, 3500.0, 0.0],
                   [6000.0, 3300.0, 0.0]])
    rec_z, rec_x, das_w = tdas.cable_to_receivers(
        tdas.spline_fiber(cp, npts=400), cfg.dx, cfg.dz)
    plan = ce.plan_fast_path(cfg, rec_z + 32, rec_x + 32, das_w=das_w)
    assert isinstance(plan.rs, ce.FiberSurvey) and plan.rs.n_rec == 400
    ptr, plane, cell, e_rec, e_ch, e_coef = ce._injection_table(cfg, plan.rs)
    assert ptr[-1] == len(e_rec) == 400 * 10          # 4 + 6 samples a point
    assert len(plane) < len(e_rec)                    # neighbours share cells
    meta = lambda *s_: torch.zeros(s_, device="meta").requires_grad_()
    with pytest.raises(RuntimeError, match="simulated"):
        ce.propagate_cuda_plan(
            plan, meta(nz, nx), meta(nz, nx), meta(nz, nx), meta(1, 1001),
            np.array([33]), np.array([nx // 2]), np.ones(1))


# One H100's budget: 3/8 of 80 GiB (`hbm_budget_bytes` on the card).
BUDGET = (80 * 2 ** 30 * 3) // 8


@pytest.mark.parametrize("nz,nx,nt,shots,want,strips_alone", [
    (165, 265, 1501, 19, 0, 0),      # the reference workload: unchunked
    (560, 720, 2001, 19, 0, 0),      # 11.1 GB of strips and planes
    (814, 2064, 2001, 24, 22, 0),    # strips 27.6 GB, planes 7.1 GB more
    (814, 2064, 601, 24, 0, 0),      # planes nearly equal to the strips
])
def test_auto_shot_chunk_counts_the_planes(nz, nx, nt, shots, want,
                                           strips_alone):
    """A chunk is sized by the strips and the 44 state planes a shot.  At
    814x2064, nt=2001, 24 shots the strips alone fit the budget and the
    planes beside them do not."""
    cfg = tcfg.SimConfig(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=nt, dt=0.001,
                         f0=10.0, npml=32)
    strips = tpar.strip_bytes_per_shot(cfg)
    planes = tpar.state_bytes_per_shot(cfg)
    assert strips == (nt - 1) * 5 * 2 * 5 * (nz + nx) * 4
    assert planes == 44 * nz * nx * 4
    assert tpar.auto_shot_chunk(cfg, shots, budget_bytes=BUDGET) == want
    fits_alone = strips * shots <= BUDGET
    assert fits_alone == (strips_alone == 0)
    if want:
        assert (strips + planes) * want <= BUDGET < \
            (strips + planes) * (want + 1)
