"""The point receivers' cotangents inside the fused elastic and acoustic
reverse steps, and the acoustic recording inside the fused acoustic forward
step, on the CPU.

* cuda_engine._injection_tiles, the per-plan table that tells each block of
  the fused reverse step which rows of the injection table it adds: every
  vz/vx row in exactly the tiles whose 2-cell halo around them holds its
  cell (up to four), every szz/sxx row in its owner tile alone, each run in
  table order, and together every row of `_injection_table`; on every
  FIBER_CASES survey, the fiber points of TILE_EDGE_CASES and a cable that
  doubles back over its own cells.  The same of the acoustic table (p rows
  in their owner alone) on the point cases of AC_TILE_EDGE_CASES and the
  doubling cable.  FastPlan.receivers uploads each with the tiles it was
  built for.
* launches_forward_acoustic, launches_backward and
  launches_backward_acoustic: nt launches a forward and a backward, for
  point receivers and for a row.
* The plain acoustic forward on the point cases of AC_TILE_EDGE_CASES
  against the JAX package's XLA acoustic engine in float64, 1e-12 of each
  channel's max; the plain elastic and acoustic gradients on the points by
  a neighbour's halo against the JAX package's XLA engines in float64,
  1e-12 of each gradient's max on the interior (the acoustic one's tight
  interior; d_stf whole).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_inject.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu import acoustic as jac
from sep2023_tpu_torch import propagator
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.ops import cuda_acoustic as ca
from sep2023_tpu_torch.ops import cuda_engine as ce
from sep2023_tpu_torch.testing import (AC_TILE_EDGE_CASES, FIBER_CASES,
                                       TILE_EDGE_CASES, ac_tile_edge_problem,
                                       doubling_cable, fiber_problem,
                                       tile_edge_problem)

F64_TOL = 1e-12
HALO_CASE = "points by a neighbour's halo"
POINT_EDGE_CASES = [k for k, v in TILE_EDGE_CASES.items()
                    if v[-1][0] == "points"]
AC_POINT_EDGE_CASES = [k for k, v in AC_TILE_EDGE_CASES.items()
                       if v[-1][0] == "points"]
VELOCITY_PLANES = (ce._A_VZ, ce._A_VX)
AC_VELOCITY_PLANES = (ce._AC_A_VZ, ce._AC_A_VX)

SURVEYS = {
    **{f"fiber: {k}": lambda k=k: fiber_problem(k, device="cpu")[:2]
       for k in FIBER_CASES},
    **{f"tile edges: {k}": lambda k=k: tile_edge_problem(k, device="cpu")[:2]
       for k in POINT_EDGE_CASES},
    "cable that doubles back": doubling_cable,
}
AC_SURVEYS = {
    **{f"tile edges: {k}": lambda k=k: ac_tile_edge_problem(
        k, device="cpu")[:2] for k in AC_POINT_EDGE_CASES},
    "cable that doubles back": doubling_cable,
}


def _tiles_reading(cfg, plane, cell, tile, velocity=VELOCITY_PLANES):
    """(rows, tiles) bool: the tiles whose fused reverse step reads each
    row's cell, by brute force over every tile: a row of a `velocity`
    plane (vz/vx) on the tile or its 2-cell halo, any other row (szz/sxx,
    or the acoustic p) on the tile."""
    tz, tx = tile
    n_tz, n_tx = -(-cfg.nz // tz), -(-cfg.nx // tx)
    z, x = (cell // cfg.nx)[:, None], (cell % cfg.nx)[:, None]
    h = np.where(np.isin(plane, velocity), 2, 0)[:, None]
    ty, tx_ = np.divmod(np.arange(n_tz * n_tx), n_tx)
    return ((z >= ty * tz - h) & (z < (ty + 1) * tz + h)
            & (x >= tx_ * tx - h) & (x < (tx_ + 1) * tx + h))


def _hold_tiles(cfg, fs, tile, acoustic):
    """The injection table's rows by tile against `_tiles_reading`: each
    row listed in the tiles that read its cell and no other, vz/vx rows
    first in a tile, each run in table order, the owner-only rows in one
    tile, every row.  Returns the tiles a row (rows,)."""
    vplanes = AC_VELOCITY_PLANES if acoustic else VELOCITY_PLANES
    _, plane, cell, *_ = ce._injection_table(cfg, fs, acoustic)
    n_rows = len(plane)
    n_tiles = -(-cfg.nz // tile[0]) * -(-cfg.nx // tile[1])
    ptr, rows = ce._injection_tiles(cfg, plane, cell, tile, acoustic)
    assert ptr.dtype == rows.dtype == np.int32
    assert ptr.shape == (2 * n_tiles + 1,)
    assert ptr[0] == 0 and ptr[-1] == len(rows)
    assert (np.diff(ptr) >= 0).all()
    velocity = np.isin(plane, vplanes)
    assert velocity.any() and not velocity.all()
    listed = np.zeros((n_rows, n_tiles), bool)
    for t in range(n_tiles):
        run_v = rows[ptr[2 * t]:ptr[2 * t + 1]]
        run_s = rows[ptr[2 * t + 1]:ptr[2 * t + 2]]
        assert velocity[run_v].all() and not velocity[run_s].any()
        # each run in table order (the elastic table lists its vz/vx rows
        # before its szz/sxx rows, the acoustic one its p rows first)
        assert (np.diff(run_v) > 0).all() and (np.diff(run_s) > 0).all()
        if not acoustic:
            assert (np.diff(np.concatenate([run_v, run_s])) > 0).all()
        listed[run_v, t] = listed[run_s, t] = True
    assert (listed == _tiles_reading(cfg, plane, cell, tile, vplanes)).all()
    per_row = listed.sum(axis=1)
    assert (per_row[~velocity] == 1).all()       # the owner alone
    assert ((per_row >= 1) & (per_row <= 4)).all()
    assert len(rows) == per_row.sum()            # every row, none twice
    return per_row


@pytest.mark.parametrize("tile", [ce.TILE, (8, 16)])
@pytest.mark.parametrize("survey", SURVEYS)
def test_injection_tiles_hold_each_row_where_it_is_read(survey, tile):
    cfg, fs = SURVEYS[survey]()
    per_row = _hold_tiles(cfg, fs, tile, acoustic=False)
    if survey == f"tile edges: {HALO_CASE}" and tile == ce.TILE:
        assert per_row.max() == 4    # (14, 30): a corner of four tiles


@pytest.mark.parametrize("tile", [ce.TILE, (8, 16)])
@pytest.mark.parametrize("survey", AC_SURVEYS)
def test_acoustic_injection_tiles_hold_each_row_where_it_is_read(survey,
                                                                  tile):
    """The acoustic table (planes p, vz, vx = 0, 1, 2): its vz and vx rows
    in every tile whose 2-cell halo holds their cell, its p rows in their
    owner alone, against the brute force with the acoustic velocity
    planes; the elastic planes' rule (planes 2 and 3 owner-only) would put
    every vx row in its owner alone and every p row in up to four tiles."""
    cfg, fs = AC_SURVEYS[survey]()
    per_row = _hold_tiles(cfg, fs, tile, acoustic=True)
    _, plane, cell, *_ = ce._injection_table(cfg, fs, acoustic=True)
    assert (per_row[plane == ce._AC_A_P] == 1).all()
    elastic_rule = ce._injection_tiles(cfg, plane, cell, tile)
    assert elastic_rule[1].tolist() != \
        ce._injection_tiles(cfg, plane, cell, tile, acoustic=True)[1].tolist()
    if survey == f"tile edges: {HALO_CASE}" and tile == ce.TILE:
        assert per_row.max() == 4    # (14, 30): a corner of four tiles


def test_plan_uploads_the_injection_tiles_for_the_kernels_tiles():
    """FastPlan.receivers carries (tile_ptr, tile_inj, TILE) of its
    injection table for the elastic kernels and, built on the acoustic
    table with the acoustic planes, for the acoustic ones; no tables for a
    receiver row."""
    cfg, fs = tile_edge_problem(HALO_CASE, device="cpu")[:2]
    plan = ce.FastPlan(cfg, fs)
    cpu = torch.device("cpu")
    for acoustic in (False, True):
        rec = plan.receivers(cpu, acoustic=acoustic)
        ptr, rows, tile = rec[5]
        assert tile == ce.TILE
        table = ce._injection_table(cfg, fs, acoustic)
        assert [t.tolist() for t in rec[3]] == [a.tolist() for a in table]
        want = ce._injection_tiles(cfg, table[1], table[2], ce.TILE,
                                   acoustic)
        assert ptr.tolist() == want[0].tolist()
        assert rows.tolist() == want[1].tolist()
    row_cfg = doubling_cable()[0]
    assert ce.FastPlan(row_cfg, ce.RowSurvey(20, 12, 40)).receivers(cpu) \
        is None


@pytest.mark.parametrize("nt", [1, 2, 3, 260, 1501])
def test_launches_are_nt(nt):
    """An acoustic forward, an elastic backward and an acoustic backward
    (or imaging call), with point receivers or a row: nt launches (none for
    an acoustic forward below nt = 2; a backward always launches its shot
    sum)."""
    cfg = SimConfig(nz=64, nx=96, dz=20.0, dx=20.0, nt=nt, dt=0.002,
                    f0=10.0, npml=10)
    fiber = ce.make_fiber_survey([20, 21], [30, 33])
    row = ce.RowSurvey(20, 12, 40)
    assert ca.launches_forward_acoustic(cfg) == (nt if nt > 1 else 0)
    assert ce.launches_backward(cfg, fiber) == nt
    assert ce.launches_backward(cfg, row) == nt
    assert ca.launches_backward_acoustic(cfg, fiber) == nt
    assert ca.launches_backward_acoustic(cfg, row) == nt


@pytest.mark.parametrize("case", AC_POINT_EDGE_CASES)
def test_acoustic_points_plain_matches_xla_f64(case):
    """The plain acoustic forward (forward_plain_acoustic, float64) on a
    point case of AC_TILE_EDGE_CASES against the JAX XLA acoustic engine
    (acoustic.propagate_acoustic under jax.vmap, float64) on the same numpy
    inputs: each channel within 1e-12 of its max."""
    cfg, fs, args = ac_tile_edge_problem(case, device="cpu")
    lam, rho, stf = (a.double().numpy() for a in args[:3])
    jcfg = st.SimConfig(nz=cfg.nz, nx=cfg.nx, dz=cfg.dz, dx=cfg.dx,
                        nt=cfg.nt, dt=cfg.dt, f0=cfg.f0, npml=cfg.npml)
    geoms = ca._geoms(cfg, fs, *args[3:], "cpu")
    jgeoms = jac.AcGeom(*(jnp.asarray(g.numpy()) for g in geoms))
    ref = np.asarray(jax.jit(jax.vmap(
        lambda s, g: jac.propagate_acoustic(jcfg, jnp.asarray(lam),
                                            jnp.asarray(rho), s, g)))(
        jnp.asarray(stf), jgeoms))
    out = ca.forward_plain_acoustic(cfg, fs, *(torch.from_numpy(a) for a in
                                               (lam, rho, stf)),
                                    *args[3:]).numpy()
    S, R = len(args[3]), fs.n_rec
    assert out.shape == ref.shape == (S, 3, R, cfg.nt)
    for c in range(3):
        scale = np.abs(ref[:, c]).max()
        assert scale > 0
        assert np.abs(out[:, c] - ref[:, c]).max() < F64_TOL * scale, c


def test_halo_points_plain_gradient_matches_xla_f64():
    """The plain elastic gradient (propagator.propagate_shots and its
    boundary-saving adjoint, float64) of a seeded data cotangent on the
    points by a neighbour's halo (weighted strain, each receiver its own
    weights, cells visited twice) against jax.vjp through the JAX XLA
    engine (st.propagate under jax.vmap, float64): the cotangents of lam,
    mu and rho within 1e-12 of each one's max on the interior, of stf
    whole."""
    cfg, fs, args = tile_edge_problem(HALO_CASE, device="cpu")
    lam, mu, rho, stf = (a.double().numpy() for a in args[:4])
    src_z, src_x, rxz = args[4:]
    jcfg = st.SimConfig(nz=cfg.nz, nx=cfg.nx, dz=cfg.dz, dx=cfg.dx,
                        nt=cfg.nt, dt=cfg.dt, f0=cfg.f0, npml=cfg.npml,
                        das_channel=cfg.das_channel)
    S, R = len(src_z), fs.n_rec
    d = np.random.default_rng(11).standard_normal((S, 4, R, cfg.nt))
    jgeoms = st.ShotGeom(
        src_z=jnp.asarray(src_z, jnp.int32),
        src_x=jnp.asarray(src_x, jnp.int32),
        rxz=jnp.asarray(rxz, jnp.float64),
        rec_z=jnp.broadcast_to(jnp.asarray(fs.rec_z, jnp.int32), (S, R)),
        rec_x=jnp.broadcast_to(jnp.asarray(fs.rec_x, jnp.int32), (S, R)),
        das_w=jnp.broadcast_to(jnp.asarray(fs.weights, jnp.float64),
                               (S, R, 3)))
    fwd = lambda l, m, r, s: jax.vmap(
        lambda si, g: st.propagate(jcfg, l, m, r, si, g))(s, jgeoms)

    def data_and_vjp(l, m, r, s, d_):
        out, vjp = jax.vjp(fwd, l, m, r, s)
        return out, vjp(d_)

    ref, ref_grads = jax.jit(data_and_vjp)(
        *(jnp.asarray(a) for a in (lam, mu, rho, stf, d)))

    ins = [torch.from_numpy(a).requires_grad_() for a in (lam, mu, rho, stf)]
    geoms = ce._geoms(cfg, fs, src_z, src_x, rxz, "cpu", torch.float64)
    data = propagator.propagate_shots(cfg, *ins, geoms)
    grads = torch.autograd.grad(data, ins, torch.from_numpy(d))
    assert np.abs(data.detach().numpy() - np.asarray(ref)).max() \
        < F64_TOL * np.abs(np.asarray(ref)).max()
    n = cfg.npml
    inner = (slice(n, cfg.nz - n), slice(n, cfg.nx - n))
    for name, a, b in zip(("lam", "mu", "rho", "stf"), grads, ref_grads):
        a, b = a.numpy(), np.asarray(b)
        if name != "stf":
            a, b = a[inner], b[inner]
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() < F64_TOL * scale, name


def test_halo_points_plain_acoustic_gradient_matches_xla_f64():
    """The plain acoustic gradient (backward_plain_acoustic after
    forward_plain_acoustic_strips, float64) of a seeded data cotangent on
    the acoustic points by a neighbour's halo against jax.vjp through the
    JAX XLA acoustic engine (acoustic.propagate_acoustic under jax.vmap,
    float64): the cotangents of lam and rho within 1e-12 of each one's max
    on the tight interior, of stf whole.  On the card the fused kernel,
    which adds these points' cotangents inside its reverse step, is held to
    this plain version."""
    cfg, fs, args = ac_tile_edge_problem(HALO_CASE, device="cpu")
    lam, rho, stf = (a.double().numpy() for a in args[:3])
    jcfg = st.SimConfig(nz=cfg.nz, nx=cfg.nx, dz=cfg.dz, dx=cfg.dx,
                        nt=cfg.nt, dt=cfg.dt, f0=cfg.f0, npml=cfg.npml)
    geoms = ca._geoms(cfg, fs, *args[3:], "cpu")
    S, R = len(args[3]), fs.n_rec
    d = np.random.default_rng(13).standard_normal((S, 3, R, cfg.nt))
    jgeoms = jac.AcGeom(*(jnp.asarray(g.numpy()) for g in geoms))
    fwd = lambda l, r, s: jax.vmap(
        lambda si, g: jac.propagate_acoustic(jcfg, l, r, si, g))(s, jgeoms)

    def data_and_vjp(l, r, s, d_):
        out, vjp = jax.vjp(fwd, l, r, s)
        return out, vjp(d_)

    ref, ref_grads = jax.jit(data_and_vjp)(
        *(jnp.asarray(a) for a in (lam, rho, stf, d)))

    ins = tuple(torch.from_numpy(a) for a in (lam, rho, stf))
    data, strips, final = ca.forward_plain_acoustic_strips(cfg, fs, *ins,
                                                           *args[3:])
    assert np.abs(data.numpy() - np.asarray(ref)).max() \
        < F64_TOL * np.abs(np.asarray(ref)).max()
    grads = ca.backward_plain_acoustic(cfg, fs, *ins, *args[3:], final,
                                       strips, torch.from_numpy(d))
    n = cfg.npml + 2
    tight = (slice(n, cfg.nz - n), slice(n, cfg.nx - n))
    for name, a, b in zip(("lam", "rho", "stf"), grads, ref_grads):
        a, b = a.numpy(), np.asarray(b)
        if name != "stf":
            a, b = a[tight], b[tight]
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() < F64_TOL * scale, name
