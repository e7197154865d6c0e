"""The elastic forward's recording inside its fused step, on the CPU.

* cuda_engine._tile_table, the per-plan table by tile that tells each block
  of the fused forward which point receivers it records: every receiver
  appears once, in the tile that owns its cell, in receiver order within a
  tile, and tile_ptr is monotone over all tiles; on every FIBER_CASES
  survey, the fiber points of TILE_EDGE_CASES and a cable that doubles back
  over its own cells.  FastPlan.receivers uploads it with the tiles it was
  built for, which are csrc/elastic_common.cuh's kTileZ x kTileX.
* launches_forward: nt launches a forward (nt-1 fused steps and the
  record-only launch), none below nt = 2.
* The plain forward on the point cases of TILE_EDGE_CASES, cells visited
  two to four times among them, against the JAX package's XLA engine in
  float64: 1e-12 of each channel's max.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sep2023_tpu as st
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.ops import cuda_engine as ce
from sep2023_tpu_torch.testing import (FIBER_CASES, TILE_EDGE_CASES,
                                       doubling_cable, fiber_problem,
                                       tile_edge_problem)

F64_TOL = 1e-12
POINT_EDGE_CASES = [k for k, v in TILE_EDGE_CASES.items()
                    if v[-1][0] == "points"]


SURVEYS = {
    **{f"fiber: {k}": lambda k=k: fiber_problem(k, device="cpu")[:2]
       for k in FIBER_CASES},
    **{f"tile edges: {k}": lambda k=k: tile_edge_problem(k, device="cpu")[:2]
       for k in POINT_EDGE_CASES},
    "cable that doubles back": doubling_cable,
}


@pytest.mark.parametrize("tile", [ce.TILE, (8, 16)])
@pytest.mark.parametrize("survey", SURVEYS)
def test_tile_table_holds_each_receiver_once_in_its_tile(survey, tile):
    cfg, fs = SURVEYS[survey]()
    tz, tx = tile
    n_tx = -(-cfg.nx // tx)
    n_tiles = -(-cfg.nz // tz) * n_tx
    ptr, rec = ce._tile_table(cfg, fs, tile)
    assert ptr.dtype == rec.dtype == np.int32
    assert ptr.shape == (n_tiles + 1,) and rec.shape == (fs.n_rec,)
    assert ptr[0] == 0 and ptr[-1] == fs.n_rec
    assert (np.diff(ptr) >= 0).all()
    assert sorted(rec.tolist()) == list(range(fs.n_rec))
    z, x = np.asarray(fs.rec_z), np.asarray(fs.rec_x)
    for t in range(n_tiles):
        run = rec[ptr[t]:ptr[t + 1]]
        assert (np.diff(run) > 0).all()             # receiver order
        assert ((z[run] // tz) * n_tx + x[run] // tx == t).all()
    if "duplicate" in survey or "doubles" in survey:
        cells = list(zip(z.tolist(), x.tolist()))
        assert len(set(cells)) < len(cells)     # cells visited twice


def test_plan_uploads_the_tile_table_for_the_kernels_tiles():
    """FastPlan.receivers carries (tile_ptr, tile_rec, TILE), TILE is the
    kernels' kTileZ x kTileX, and the acoustic tables carry it too."""
    header = (Path(ce.__file__).resolve().parents[1] / "csrc"
              / "elastic_common.cuh").read_text()
    kernel_tile = tuple(int(re.search(rf"constexpr int {k} = (\d+);",
                                      header).group(1))
                        for k in ("kTileZ", "kTileX"))
    assert ce.TILE == kernel_tile
    cfg, fs = doubling_cable()
    plan = ce.FastPlan(cfg, fs)
    for acoustic in (False, True):
        ptr, rec, tile = plan.receivers(torch.device("cpu"), acoustic)[4]
        assert tile == ce.TILE
        want = ce._tile_table(cfg, fs, ce.TILE)
        assert ptr.tolist() == want[0].tolist()
        assert rec.tolist() == want[1].tolist()


@pytest.mark.parametrize("nt", [1, 2, 3, 260, 1501])
def test_launches_forward_is_nt(nt):
    cfg = SimConfig(nz=64, nx=96, dz=20.0, dx=20.0, nt=nt, dt=0.002,
                    f0=10.0, npml=10)
    assert ce.launches_forward(cfg) == (nt if nt > 1 else 0)


@pytest.mark.parametrize("case", POINT_EDGE_CASES)
def test_tile_edge_points_plain_matches_xla_f64(case):
    """The plain forward (forward_plain, float64) against the JAX XLA
    engine (st.propagate under jax.vmap, float64) on the same numpy
    inputs: data per channel, the weighted ett of every receiver, two
    receivers of one cell each with its own weights among them."""
    cfg, fs, args = tile_edge_problem(case, device="cpu")
    lam, mu, rho, stf = (a.double().numpy() for a in args[:4])
    src_z, src_x, rxz = args[4:]
    jcfg = st.SimConfig(nz=cfg.nz, nx=cfg.nx, dz=cfg.dz, dx=cfg.dx,
                        nt=cfg.nt, dt=cfg.dt, f0=cfg.f0, npml=cfg.npml,
                        das_channel=cfg.das_channel)
    S, R = len(src_z), fs.n_rec
    geoms = st.ShotGeom(
        src_z=jnp.asarray(src_z, jnp.int32),
        src_x=jnp.asarray(src_x, jnp.int32),
        rxz=jnp.asarray(rxz, jnp.float64),
        rec_z=jnp.broadcast_to(jnp.asarray(fs.rec_z, jnp.int32), (S, R)),
        rec_x=jnp.broadcast_to(jnp.asarray(fs.rec_x, jnp.int32), (S, R)),
        das_w=jnp.broadcast_to(jnp.asarray(fs.weights, jnp.float64),
                               (S, R, 3)))
    ref = np.asarray(jax.jit(jax.vmap(
        lambda s, g: st.propagate(jcfg, *(jnp.asarray(a) for a in
                                          (lam, mu, rho)), s, g)))(
        jnp.asarray(stf), geoms))
    out = ce.forward_plain(cfg, fs, *(torch.from_numpy(a) for a in
                                      (lam, mu, rho, stf)),
                           src_z, src_x, rxz).numpy()
    assert out.shape == ref.shape == (S, 4, R, cfg.nt)
    for c in range(4):
        scale = np.abs(ref[:, c]).max()
        assert scale > 0
        assert np.abs(out[:, c] - ref[:, c]).max() < F64_TOL * scale, c
