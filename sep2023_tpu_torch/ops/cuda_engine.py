"""Elastic engine on the GPU: the hand-written CUDA kernels
`csrc/elastic_fwd.cu` (forward, optionally saving the boundary strips) and
`csrc/elastic_bwd.cu` (the boundary-saving adjoint), their plain PyTorch
versions, and the acquisition planning in front of them.

Counterpart of `sep2023_tpu/ops/pallas_engine.py`: `plan_fast_path` and
`FastPlan` of the planning there, `forward_cuda_plan` of
`forward_pallas_plan`/`_run_forward` (K1), `backward_cuda_plan` of
`_run_backward` (K2), and `propagate_cuda_plan`, a
`torch.autograd.Function`, of `propagate_pallas_plan` with
`_pp_fwd`/`_pp_bwd`, and `snapshots_cuda_plan` of
`propagator.propagate_snapshots` (the forward kernel's state copied on the
card every save_every steps).  Every entry takes a plan; `plan_for(cfg,
rs)` gives the plan of a survey already in hand.
Receivers are a `RowSurvey` (one contiguous row) or a `FiberSurvey`
(arbitrary points, optionally with directional weights).  The JAX package's
K-layer row maps and its transposed plan for receiver columns are TPU
devices and are not carried over: a CUDA thread gathers a point, so a curved
fiber, a multi-row spread and a column are all a `FiberSurvey`.  Nor is its
fused/streamed choice: the kernels keep all state in device memory, so one
pair runs every grid size (it is the counterpart of the streamed pair,
`pallas_stream.py`, too).

Data is (S, 4, n_rec, nt) float32, receivers in the caller's order.  The
strips are (S, nt-1, 5, strip_len) in the flat layout of
`propagator._extract_strips`, the final fields (5, S, nz, nx) in Fields
order; kernels and plain versions share both.

The kernels run one fused launch a step over tiles in shared memory
(elastic_common.cuh), with the fields and what a step reads at neighbours
held twice, and the CPML memories only in their bands (`cpml_bands`);
`state_floats_per_shot` counts what a gradient holds a shot.  The forward
records inside its fused step, from the state the step reads, and one
record-only launch of the same kernel after the last step records the last
sample: nt launches a forward, for a receiver row and for points alike.
Points are recorded by the tile that owns their cell, from a per-plan table
by tile (`_tile_table`, built for `TILE`; the kernel refuses a table of
other tiles).  The backward adds the points' cotangents inside its fused
reverse step, from the injection table and its rows by the tiles that read
them (`_injection_tiles`, built for `TILE` too): nt launches a backward,
nt-1 fused steps and the shot sum, for a receiver row and for points alike.

The wrappers take their plain versions only for tensors that lie on the
CPU.  On CUDA tensors they launch the kernels or raise: they never drop to
the plain versions or to the CPU.  `LAUNCHES` and `LAUNCHES_BWD` count the
kernel launches (`LAUNCHES_STRIPS` the forward's with strip saving,
`LAUNCHES_FIBER` the record-only launches of point-receiver forwards among
them) and `PLAIN_CALLS` the calls of each plain version, so a run can show
which path it went through.  Every update of them holds `COUNT_LOCK`:
the shard threads of a sharded loss (`parallel._on_mesh`) launch at once.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from sep2023_tpu_torch import cpml as cpml_mod
from sep2023_tpu_torch import propagator, spans
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.medium import material_fields
from sep2023_tpu_torch.ops import _build
from sep2023_tpu_torch.propagator import Fields, ShotGeom

# Kernel launches made by forward_cuda_plan: nt a forward (nt-1 fused
# steps, each recording the state it reads, and one record-only launch of
# the same kernel for the last sample), with or without strip saving, row
# or point receivers.  Read and reset by callers that check the path they
# ran.
LAUNCHES = 0
# The part of LAUNCHES made with strip saving (the gradient's forward).
LAUNCHES_STRIPS = 0
# The part of LAUNCHES that only recorded at points: the record-only launch,
# 1 a FiberSurvey forward (its steps record inside the fused step).
LAUNCHES_FIBER = 0
# Kernel launches made by backward_cuda_plan and reconstruct_cuda_plan: 1 a
# step (the fused reverse step, which adds point receivers' cotangents
# itself) and 1 shot sum, row or point receivers.
LAUNCHES_BWD = 0
# Kernel launches made by illumination_cuda_plan: 1 a step (the fused step
# with the illumination accumulator, no record).
LAUNCHES_ILL = 0
# Calls of each plain version (on CPU tensors, or by a caller comparing),
# those of the acoustic engine (ops/cuda_acoustic.py) and
# imaging.source_illumination, the plain version of illumination_cuda_plan,
# included; and the calls of the plain engine on whatever device its
# tensors lie (the JAX package's XLA engine): "propagate"
# (propagator.propagate_shots), "propagate_acoustic"
# (acoustic.propagate_acoustic_shots), "rtm_image_time"
# (acoustic.rtm_image_time_shots) and "propagate_dd" (a mesh row of
# parallel.make_dd_misfit).
PLAIN_CALLS = {"forward_plain": 0, "forward_plain_strips": 0,
               "backward_plain": 0, "reconstruct_plain": 0,
               "forward_plain_acoustic": 0,
               "forward_plain_acoustic_strips": 0,
               "backward_plain_acoustic": 0,
               "reconstruct_plain_acoustic": 0, "rtm_image_time_plain": 0,
               "source_illumination": 0, "snapshots_plain": 0,
               "propagate": 0, "propagate_acoustic": 0, "rtm_image_time": 0,
               "propagate_dd": 0}
# Held by every update of the counters above and of the acoustic engine's,
# which are read-modify-writes shared by the threads of a sharded loss.
COUNT_LOCK = threading.Lock()


def count_plain(name: str) -> None:
    """Add one to PLAIN_CALLS[name], under COUNT_LOCK."""
    with COUNT_LOCK:
        PLAIN_CALLS[name] += 1

# Planes of nz x nx a shot, as the wrappers allocate them: the fields twice
# (the kernels' double buffer, the forward's and the backward's), the
# backward's work planes (the stresses' cotangents once; those of vz, vx
# and the stress stencils' cotangents D1..D4 twice), the per-shot
# gradients; and CPML memories of each axis in band storage (the forward's
# 4 stress-phase memories twice and 4 velocity-phase ones once; the
# backward's the other way round).
N_STATE_PLANES = 10
N_WORK_PLANES = 15
N_GRAD_PLANES = 5
N_BAND_PLANES = 6

ETT_MODES = {"exx": 0, "ezz": 1, "weighted": 2}  # EttMode, elastic_common.cuh
# (kTileZ, kTileX) of csrc/elastic_common.cuh: the tiles the point tables
# are built for; the kernels refuse tables built for others.
TILE = (16, 32)
# Adjoint planes of the work buffer that take receiver cotangents (InjPlane,
# elastic_bwd.cu).
_A_VZ, _A_VX, _A_SZZ, _A_SXX = 0, 1, 2, 3
# The same of the acoustic work buffer (Work, acoustic_bwd.cu).
_AC_A_P, _AC_A_VZ, _AC_A_VX = 0, 1, 2

def launches_forward(cfg: SimConfig) -> int:
    """Launches of one forward_cuda_plan call on the card: nt (nt-1 fused
    steps and the record-only launch), none for nt < 2."""
    return cfg.nt if cfg.nt > 1 else 0


def launches_backward(cfg: SimConfig, rs) -> int:
    """Launches of one backward_cuda_plan call on the card: nt, the nt-1
    fused reverse steps and the shot sum, for a receiver row and for point
    receivers (rs, the plan's survey) alike."""
    return cfg.nt


@functools.lru_cache(maxsize=64)
def _profile_rows(cfg: SimConfig):
    """(6, nz) and (6, nx) float32 CPML profile rows in cpml.CpmlScaled
    order (ik, a, b, ik_h, a_h, b_h), built in float64 and cast: what the
    kernels read."""
    cp = cpml_mod.cpml_scaled(cfg.nz, cfg.nx, cfg.npml, cfg.dz, cfg.dx,
                              cfg.dt, cfg.f0, dtype=np.float32)
    return (np.stack([p.reshape(-1) for p in cp[:6]]),
            np.stack([p.reshape(-1) for p in cp[6:]]))


def _band(rows) -> tuple[int, int]:
    """(lo, hi) of one axis: a and a_h (rows 1 and 4) are 0 exactly on
    [lo, hi) and the band is [0, lo) and [hi, n)."""
    n = rows.shape[1]
    zero = np.flatnonzero((rows[1] == 0) & (rows[4] == 0))
    if zero.size == 0:
        return n, n
    lo, hi = int(zero[0]), int(zero[-1]) + 1
    if (rows[1, lo:hi] != 0).any() or (rows[4, lo:hi] != 0).any():
        raise ValueError("the CPML profile's a is not 0 between its bands")
    return lo, hi


def cpml_bands(cfg: SimConfig) -> tuple[int, int, int, int]:
    """(z_lo, z_hi, x_lo, x_hi): the CPML bands of the kernels, the rows
    z < z_lo or z >= z_hi and the columns x < x_lo or x >= x_hi, where the
    float32 profiles' a or a_h is not 0.  Between them a = 0 exactly, the
    CPML memory stays 0 and the kernels keep none.  Taken from a, not b: at
    the PML's inner edge b != 1 where a = 0."""
    pz, px = _profile_rows(cfg)
    return (*_band(pz), *_band(px))


def band_floats(cfg: SimConfig) -> int:
    """Floats of one z-memory and one x-memory plane of a shot in band
    storage: nbz x nx + nz x nbx."""
    z_lo, z_hi, x_lo, x_hi = cpml_bands(cfg)
    return ((cfg.nz - (z_hi - z_lo)) * cfg.nx
            + cfg.nz * (cfg.nx - (x_hi - x_lo)))


def state_floats_per_shot(cfg: SimConfig) -> int:
    """Floats a shot's gradient holds beside its strips while the backward
    runs: the forward's final fields, the backward's double buffer of the
    fields, its work planes, its per-shot gradients and its CPML memories
    in band storage."""
    planes = 5 + N_STATE_PLANES + N_WORK_PLANES + N_GRAD_PLANES
    return planes * cfg.nz * cfg.nx + N_BAND_PLANES * band_floats(cfg)


class RowSurvey(NamedTuple):
    """Receivers on one grid row with contiguous x (the reference's
    surveyGen layout, fwi_utils.py:87-124), padded-grid indices."""

    rec_row: int
    rec_x0: int
    n_rec: int


class FiberSurvey(NamedTuple):
    """Receivers at arbitrary padded-grid points, in the caller's order:
    curved and dipping fibers, multi-row spreads, columns, and cables that
    visit a cell twice (each receiver gets its own sample).  Hashable
    (tuples), so a plan can be cached by it.

    rec_z, rec_x: (R,) ints
    weights:      (R, 3) per-receiver (exx, exz, ezz) sensitivity weights,
                  required when the config's das_channel is 'weighted'
    """

    rec_z: tuple
    rec_x: tuple
    weights: tuple | None = None

    @property
    def n_rec(self) -> int:
        return len(self.rec_z)


def check_row_survey(rec_z, rec_x) -> RowSurvey | None:
    rec_z = np.asarray(rec_z)
    rec_x = np.asarray(rec_x)
    if (rec_z == rec_z[0]).all() and (np.diff(rec_x) == 1).all():
        return RowSurvey(int(rec_z[0]), int(rec_x[0]), len(rec_x))
    return None


def make_fiber_survey(rec_z, rec_x, das_w=None) -> FiberSurvey:
    """FiberSurvey of receivers at padded-grid (rec_z, rec_x), with (R, 3)
    weights or None."""
    rec_z = np.asarray(rec_z, np.int64).reshape(-1)
    rec_x = np.asarray(rec_x, np.int64).reshape(-1)
    w = None
    if das_w is not None:
        das_w = np.asarray(das_w, np.float64)
        if das_w.shape != (len(rec_z), 3):
            raise ValueError(f"das_w must be ({len(rec_z)}, 3), got "
                             f"{das_w.shape}")
        w = tuple(map(tuple, das_w.tolist()))
    return FiberSurvey(tuple(rec_z.tolist()), tuple(rec_x.tolist()), w)


def _points_in_range(cfg: SimConfig, rec_z, rec_x) -> bool:
    """The range the JAX package plans: 1 <= z <= nz-2 with x on the grid,
    or (its transposed plan) 1 <= x <= nx-2 with z on the grid.  The point
    kernels read a neighbour outside the grid as 0, so every such receiver
    is safe."""
    z0, z1, x0, x1 = rec_z.min(), rec_z.max(), rec_x.min(), rec_x.max()
    return bool((z0 >= 1 and z1 <= cfg.nz - 2 and x0 >= 0 and x1 < cfg.nx)
                or (x0 >= 1 and x1 <= cfg.nx - 2 and z0 >= 0
                    and z1 < cfg.nz))


def _row_fits(cfg: SimConfig, rs: RowSurvey) -> bool:
    """What the row kernels read (the receiver row, and row-1 or x-1 for
    ett) lies on the grid."""
    lo_z = 1 if cfg.das_channel == "ezz" else 0
    lo_x = 1 if cfg.das_channel == "exx" else 0
    return (lo_z <= rs.rec_row < cfg.nz and lo_x <= rs.rec_x0
            and rs.n_rec >= 1 and rs.rec_x0 + rs.n_rec <= cfg.nx)


def _check_survey(cfg: SimConfig, rs) -> None:
    """Validate on the host what the kernels would otherwise read out of
    bounds through the receiver tables."""
    if cfg.das_channel not in ETT_MODES:
        raise ValueError(f"das_channel {cfg.das_channel!r}")
    if isinstance(rs, RowSurvey):
        if cfg.das_channel == "weighted":
            raise ValueError("das_channel 'weighted' needs a FiberSurvey "
                             "with weights, not a RowSurvey")
        if not _row_fits(cfg, rs):
            raise ValueError(f"{rs} does not fit the {cfg.nz}x{cfg.nx} grid "
                             f"with das_channel {cfg.das_channel!r}")
    elif isinstance(rs, FiberSurvey):
        if rs.n_rec < 1 or len(rs.rec_x) != rs.n_rec:
            raise ValueError("a FiberSurvey needs rec_z and rec_x of one "
                             "length, at least 1")
        if cfg.das_channel == "weighted" and (
                rs.weights is None or len(rs.weights) != rs.n_rec):
            raise ValueError("das_channel 'weighted' needs (R, 3) weights "
                             "in the FiberSurvey")
        if not _points_in_range(cfg, np.asarray(rs.rec_z),
                                np.asarray(rs.rec_x)):
            raise ValueError(
                f"FiberSurvey receivers outside the {cfg.nz}x{cfg.nx} "
                "grid's recordable range (1 <= z <= nz-2 or 1 <= x <= nx-2)")
    else:
        raise TypeError("the engine takes a RowSurvey or a FiberSurvey, got "
                        f"{type(rs).__name__}")


def _injection_table(cfg: SimConfig, fs: FiberSurvey, acoustic=False):
    """The point recording's transpose in gather form, as a table in
    compressed-row form: one row per touched (adjoint plane, cell), sorted
    by plane and cell, its entries (receiver, channel, coefficient) sorted by
    receiver and channel, so the kernel's thread that owns a row sums it in a
    fixed order.  Returns int32 (ptr, plane, cell, ent_rec, ent_ch) and
    float32 ent_coef.  A sample's neighbour outside the grid read as 0 in
    the forward and is dropped here.  acoustic: the table of the acoustic
    recording (pr = p, vx, vz at the receiver's own cell, no ett), on the
    adjoint planes of acoustic_bwd.cu."""
    nz, nx = cfg.nz, cfg.nx
    z = np.asarray(fs.rec_z, np.int64)
    x = np.asarray(fs.rec_x, np.int64)
    r = np.arange(fs.n_rec)
    one = np.ones(fs.n_rec)
    parts = []

    def add(plane, zz, xx, ch, coef):
        keep = (zz >= 0) & (zz < nz) & (xx >= 0) & (xx < nx)
        key = plane * (nz * nx) + zz * nx + xx
        parts.append((key[keep], r[keep], np.full(keep.sum(), ch),
                      coef[keep]))

    ett = None if acoustic else cfg.das_channel
    if acoustic:
        add(_AC_A_P, z, x, 0, one)      # pr = p
        add(_AC_A_VX, z, x, 1, one)
        add(_AC_A_VZ, z, x, 2, one)
    else:
        add(_A_SZZ, z, x, 0, one)       # pr = szz + sxx
        add(_A_SXX, z, x, 0, one)
        add(_A_VX, z, x, 1, one)
        add(_A_VZ, z, x, 2, one)
    if ett == "exx":                    # ett = vx[z,x] - vx[z,x-1]
        add(_A_VX, z, x, 3, one)
        add(_A_VX, z, x - 1, 3, -one)
    elif ett == "ezz":                  # ett = vz[z,x] - vz[z-1,x]
        add(_A_VZ, z, x, 3, one)
        add(_A_VZ, z - 1, x, 3, -one)
    elif ett == "weighted":             # w0 exx + w1 exz + w2 ezz
        w = np.asarray(fs.weights, np.float64)
        idz, idx = 1.0 / cfg.dz, 1.0 / cfg.dx
        add(_A_VX, z, x, 3, w[:, 0] * idx - 0.5 * w[:, 1] * idz)
        add(_A_VX, z, x - 1, 3, -w[:, 0] * idx)
        add(_A_VX, z + 1, x, 3, 0.5 * w[:, 1] * idz)
        add(_A_VZ, z, x, 3, w[:, 2] * idz - 0.5 * w[:, 1] * idx)
        add(_A_VZ, z, x + 1, 3, 0.5 * w[:, 1] * idx)
        add(_A_VZ, z - 1, x, 3, -w[:, 2] * idz)
    key, rec, ch, coef = (np.concatenate(c) for c in zip(*parts))
    order = np.lexsort((ch, rec, key))
    key, rec, ch, coef = key[order], rec[order], ch[order], coef[order]
    rows, first = np.unique(key, return_index=True)
    ptr = np.append(first, len(key))
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return (i32(ptr), i32(rows // (nz * nx)), i32(rows % (nz * nx)),
            i32(rec), i32(ch), np.ascontiguousarray(coef, np.float32))


def _tile_table(cfg: SimConfig, fs: FiberSurvey, tile):
    """The point receivers by the tile that owns their cell, in
    compressed-row form for tiles of tile = (z, x) cells: int32 tile_ptr
    (n_tiles + 1) and the receiver indices (R,), in receiver order within a
    tile, tiles numbered row-major over the (ceil(nz / tile z),
    ceil(nx / tile x)) grid of tiles, as the forward kernel's blocks are.
    Receiver r lies in tile_rec[tile_ptr[t]:tile_ptr[t + 1]] of its tile t,
    once."""
    tz, tx = tile
    n_tx = -(-cfg.nx // tx)
    n_tiles = -(-cfg.nz // tz) * n_tx
    z = np.asarray(fs.rec_z, np.int64)
    x = np.asarray(fs.rec_x, np.int64)
    tile_of = (z // tz) * n_tx + x // tx
    rec = np.argsort(tile_of, kind="stable")
    ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(tile_of, minlength=n_tiles))])
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return i32(ptr), i32(rec)


def _injection_tiles(cfg: SimConfig, plane, cell, tile, acoustic=False):
    """The rows of an injection table (`_injection_table`'s plane and
    cell) by the tiles of tile = (z, x) cells whose fused reverse step adds
    them: a vz or vx row in every tile whose 2-cell halo around it holds the
    row's cell (the velocity phase reads it there; up to four tiles), an
    szz or sxx row (acoustic: a p row) in the tile that owns its cell (the
    stress or pressure phase reads it on the tile alone).  Tiles numbered
    row-major as in `_tile_table`.  Returns int32 tile_ptr (2 n_tiles + 1)
    and the row indices: tile t's vz/vx rows are
    rows[tile_ptr[2t]:tile_ptr[2t + 1]], its szz/sxx (p) rows
    rows[tile_ptr[2t + 1]:tile_ptr[2t + 2]], each run in table order.
    acoustic: the planes are those of the acoustic table."""
    tz, tx = tile
    n_tz, n_tx = -(-cfg.nz // tz), -(-cfg.nx // tx)
    plane = np.asarray(plane, np.int64)
    cell = np.asarray(cell, np.int64)
    z, x = cell // cfg.nx, cell % cfg.nx
    owner = np.isin(plane, (_AC_A_P,) if acoustic else (_A_SZZ, _A_SXX))
    halo = np.where(owner, 0, 2)
    row = np.arange(len(plane))
    keys, rows = [], []
    for dz in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ty, tx_ = z // tz + dz, x // tx + dx
            keep = ((ty >= 0) & (ty < n_tz) & (tx_ >= 0) & (tx_ < n_tx)
                    & (z >= ty * tz - halo) & (z < (ty + 1) * tz + halo)
                    & (x >= tx_ * tx - halo) & (x < (tx_ + 1) * tx + halo))
            keys.append((2 * (ty * n_tx + tx_) + owner)[keep])
            rows.append(row[keep])
    key, row = np.concatenate(keys), np.concatenate(rows)
    order = np.lexsort((row, key))
    ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(key, minlength=2 * n_tz * n_tx))])
    return (np.ascontiguousarray(ptr, np.int32),
            np.ascontiguousarray(row[order], np.int32))


def _as_numpy(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype)


class FastPlan:
    """How an acquisition runs on the engine: the config, the survey (a
    RowSurvey or a FiberSurvey on the padded grid), and what the kernels
    need from them on a device, validated and uploaded once per (plan,
    device) and not per call: the receiver tables (the points, their
    weights, the backward's injection table) and the source tables of each
    distinct (src_z, src_x, rxz) a caller passes (a chunked loss passes the
    same few every evaluation; the 256 most recent are kept).  Get one from
    `plan_for` or `plan_fast_path`, which cache plans by (cfg, rs)."""

    def __init__(self, cfg: SimConfig, rs):
        _check_survey(cfg, rs)
        self.cfg = cfg
        self.rs = rs
        self._receivers = {}
        self._source_tables = functools.lru_cache(maxsize=256)(
            self._upload_sources)

    def receivers(self, device: torch.device, acoustic: bool = False):
        """Point receivers' device tables: (rec_z, rec_x int32 (R,), rec_w
        float32 (R, 3) or None, the injection table of 6 tensors, the
        recording table by tile (tile_ptr, tile_rec, the `TILE` it was
        built for), the injection table's rows by tile (tile_ptr,
        tile_inj, the `TILE` they were built for)); None for a RowSurvey.
        acoustic: the tables of the acoustic kernels (no weights, the
        acoustic injection table and its rows by tile)."""
        if not isinstance(self.rs, FiberSurvey):
            return None
        hit = self._receivers.get((device, acoustic))
        if hit is None:
            up = lambda a: spans.h2d(torch.from_numpy(a).to(device))
            rs = self.rs
            rec_w = None
            if self.cfg.das_channel == "weighted" and not acoustic:
                rec_w = up(np.ascontiguousarray(rs.weights, np.float32))
            tile_ptr, tile_rec = _tile_table(self.cfg, rs, TILE)
            table = _injection_table(self.cfg, rs, acoustic)
            inj_ptr, inj_rows = _injection_tiles(self.cfg, table[1],
                                                 table[2], TILE, acoustic)
            hit = (up(np.ascontiguousarray(rs.rec_z, np.int32)),
                   up(np.ascontiguousarray(rs.rec_x, np.int32)), rec_w,
                   tuple(up(a) for a in table),
                   (up(tile_ptr), up(tile_rec), TILE),
                   (up(inj_ptr), up(inj_rows), TILE))
            self._receivers[(device, acoustic)] = hit
        return hit

    def sources(self, device: torch.device, S: int, src_z, src_x, rxz):
        """(src_z, src_x int32, rxz float32), each (S,), on `device`,
        validated against the grid."""
        sz = _as_numpy(src_z, np.int64)
        sx = _as_numpy(src_x, np.int64)
        rz = _as_numpy(rxz, np.float32)
        for name, a in (("src_z", sz), ("src_x", sx), ("rxz", rz)):
            if a.shape != (S,):
                raise ValueError(f"{name} must be ({S},), got {a.shape}")
        return self._source_tables(device, sz.tobytes(), sx.tobytes(),
                                   rz.tobytes())

    def _upload_sources(self, device, sz, sx, rz):
        sz = np.frombuffer(sz, np.int64)
        sx = np.frombuffer(sx, np.int64)
        for name, a, hi in (("src_z", sz, self.cfg.nz),
                            ("src_x", sx, self.cfg.nx)):
            if a.min() < 0 or a.max() >= hi:
                raise ValueError(f"{name} outside [0, {hi}): {a.tolist()}")
        up = lambda a: spans.h2d(torch.from_numpy(a).to(device))
        return (up(sz.astype(np.int32)), up(sx.astype(np.int32)),
                up(np.frombuffer(rz, np.float32).copy()))


@functools.lru_cache(maxsize=64)
def plan_for(cfg: SimConfig, rs) -> FastPlan:
    """The cached FastPlan of (cfg, rs); raises for a survey the kernels
    cannot take."""
    return FastPlan(cfg, rs)


def plan_fast_path(cfg: SimConfig, rec_z, rec_x, das_w=None
                   ) -> FastPlan | None:
    """Plan an acquisition (padded-grid indices): a RowSurvey where the
    receivers are one contiguous row and carry no weights, else a
    FiberSurvey; None when a receiver lies outside the recordable range
    (`_points_in_range`, the JAX package's).  das_w: (R, 3) per-receiver
    (exx, exz, ezz) weights for das_channel='weighted'."""
    rec_z = np.asarray(rec_z, np.int64).reshape(-1)
    rec_x = np.asarray(rec_x, np.int64).reshape(-1)
    if not _points_in_range(cfg, rec_z, rec_x):
        return None
    if das_w is None and cfg.das_channel != "weighted":
        rs = check_row_survey(rec_z, rec_x)
        # a row where the JAX package plans one (1 <= z <= nz-2); a row on
        # the grid's first or last row records as points
        if (rs is not None and 1 <= rs.rec_row <= cfg.nz - 2
                and _row_fits(cfg, rs)):
            return plan_for(cfg, rs)
    return plan_for(cfg, make_fiber_survey(rec_z, rec_x, das_w))


def plan_engine_name(plan: FastPlan, physics: str = "elastic",
                     device="cuda") -> str:
    """The kernel route's `engine:` line: the CUDA kernels and the plan's
    receivers on a CUDA device, their plain versions (float32, which the
    route computes) on any other, where no kernel runs."""
    kind = ("receiver row" if isinstance(plan.rs, RowSurvey)
            else f"{plan.rs.n_rec} point receivers")
    if torch.device(device).type == "cuda":
        return f"CUDA kernels ({physics}_fwd.cu + {physics}_bwd.cu), {kind}"
    return f"plain versions of the CUDA kernels ({device}, float32), {kind}"


def _check_tensor(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, lam on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _check_model(plan: FastPlan, planes, stf) -> int:
    """The material planes ((name, tensor), ...) and the wavelets are what
    the kernels take; returns the number of shots."""
    cfg = plan.cfg
    device = planes[0][1].device
    for name, t in planes:
        _check_tensor(name, t, (cfg.nz, cfg.nx), device)
    _check_tensor("stf", stf, None, device)
    if stf.ndim != 2 or stf.shape[1] != cfg.nt:
        raise ValueError(f"stf must be (S, {cfg.nt}), got {tuple(stf.shape)}")
    S = stf.shape[0]
    if not 1 <= S <= 65535:
        raise ValueError(f"{S} shots: the kernel takes 1..65535")
    return S


def _check_inputs(plan: FastPlan, lam, mu, rho, stf, src_z, src_x, rxz):
    """Validate everything the kernel would otherwise read out of bounds;
    returns the plan's (src_z, src_x, rxz) tensors on lam's device."""
    S = _check_model(plan, (("lam", lam), ("mu", mu), ("rho", rho)), stf)
    return plan.sources(lam.device, S, src_z, src_x, rxz)


def _check_residuals(plan: FastPlan, lam, stf, final, strips, d_data):
    """The backward's extra inputs: the forward's final fields and strips
    and the data cotangent, each float32, contiguous, on lam's device."""
    cfg = plan.cfg
    propagator.check_strip_grid(cfg)
    S = stf.shape[0]
    _check_tensor("final", final, (5, S, cfg.nz, cfg.nx), lam.device)
    _check_tensor("strips", strips, (S, cfg.nt - 1, 5,
                                     propagator.strip_len(cfg)), lam.device)
    _check_tensor("d_data", d_data, (S, 4, plan.rs.n_rec, cfg.nt),
                  lam.device)


def _geoms(cfg, rs, src_z, src_x, rxz, device, dtype):
    """The survey as the plain propagator's ShotGeom: a RowSurvey's row or
    a FiberSurvey's points (with its weights for the weighted channel), the
    same for every shot."""
    idx = lambda a: torch.as_tensor(a).to(device, torch.int64).reshape(-1)
    src_z = idx(src_z)
    S = src_z.shape[0]
    das_w = None
    if isinstance(rs, RowSurvey):
        rec_z = torch.full((rs.n_rec,), rs.rec_row, device=device)
        rec_x = torch.arange(rs.rec_x0, rs.rec_x0 + rs.n_rec, device=device)
    else:
        rec_z = torch.tensor(rs.rec_z, device=device)
        rec_x = torch.tensor(rs.rec_x, device=device)
        if cfg.das_channel == "weighted":
            das_w = torch.tensor(rs.weights, device=device, dtype=dtype
                                 ).expand(S, rs.n_rec, 3)
    return ShotGeom(
        src_z=src_z, src_x=idx(src_x),
        rxz=torch.as_tensor(rxz).to(device, dtype).reshape(S),
        rec_z=rec_z.expand(S, rs.n_rec), rec_x=rec_x.expand(S, rs.n_rec),
        das_w=das_w)


def forward_plain(cfg: SimConfig, rs, lam, mu, rho, stf, src_z, src_x, rxz):
    """The plain PyTorch version of the forward kernel:
    propagator.propagate_shots on the survey, on the tensors' own device."""
    count_plain("forward_plain")
    geoms = _geoms(cfg, rs, src_z, src_x, rxz, lam.device, lam.dtype)
    return propagator.propagate_shots(cfg, lam, mu, rho, stf, geoms)


@torch.no_grad()
def forward_plain_strips(cfg: SimConfig, rs, lam, mu, rho, stf,
                         src_z, src_x, rxz):
    """The plain version of the forward kernel with strip saving: (data,
    strips (S, nt-1, 5, strip_len), final fields (5, S, nz, nx))."""
    count_plain("forward_plain_strips")
    geoms = _geoms(cfg, rs, src_z, src_x, rxz, lam.device, lam.dtype)
    data, final, strips = propagator._forward(cfg, lam, mu, rho, stf, geoms,
                                              save_bnd=True)
    return data, strips, torch.stack(tuple(final))


@torch.no_grad()
def backward_plain(cfg: SimConfig, rs, lam, mu, rho, stf,
                   src_z, src_x, rxz, final, strips, d_data):
    """The plain version of the backward kernel, propagator.adjoint on the
    survey: (d_lam, d_mu, d_rho, d_stf), the material gradients kept
    inside the interior and chained through material_fields."""
    count_plain("backward_plain")
    geoms = _geoms(cfg, rs, src_z, src_x, rxz, lam.device, lam.dtype)
    gmat, d_stf, _ = propagator.adjoint(cfg, lam, mu, rho, stf, geoms,
                                        Fields(*final), strips, d_data)
    return (*propagator.material_grads(cfg, lam, mu, rho, gmat), d_stf)


@torch.no_grad()
def reconstruct_plain(cfg: SimConfig, rs, lam, mu, rho, stf,
                      src_z, src_x, rxz, final, strips):
    """The plain reconstruction alone (propagator.reconstruct): the fields
    (5, S, nz, nx) rebuilt back to t=0 from the final fields and strips."""
    count_plain("reconstruct_plain")
    geoms = _geoms(cfg, rs, src_z, src_x, rxz, lam.device, lam.dtype)
    f0 = propagator.reconstruct(cfg, lam, mu, rho, stf, geoms,
                                Fields(*final), strips)
    return torch.stack(tuple(f0))


@functools.lru_cache(maxsize=8)
def _profiles(cfg: SimConfig, device: torch.device):
    """`_profile_rows` on `device`, uploaded once per (cfg, device); the
    kernels only read them."""
    pz, px = _profile_rows(cfg)
    return (spans.h2d(torch.from_numpy(pz).to(device)),
            spans.h2d(torch.from_numpy(px).to(device)))


def _load(device):
    """The kernel library, for CUDA tensors only."""
    lib = _build.load()
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CPU or CUDA tensors, got "
                         f"{device}")
    return lib


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.elastic_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _row_args(rs):
    """(rec_row, rec_x0, n_rec) as the kernels take them; a FiberSurvey
    passes no row."""
    if isinstance(rs, RowSurvey):
        return rs.rec_row, rs.rec_x0, rs.n_rec
    return 0, 0, rs.n_rec


def forward_cuda_plan(plan: FastPlan, lam, mu, rho, stf, src_z, src_x, rxz,
                      save_strips: bool = False):
    """All-shots forward under a FastPlan (the counterpart of
    `forward_pallas_plan`).  lam/mu/rho (nz, nx) and stf (S, nt), float32
    and contiguous; src_z/src_x/rxz (S,) on the padded grid.  Returns data
    (S, 4, n_rec, nt) float32 on the tensors' device; with save_strips,
    (data, strips (S, nt-1, 5, strip_len), final fields (5, S, nz, nx)).

    CPU tensors run the plain versions; CUDA tensors run the kernel, at any
    grid size: nt launches (`launches_forward`), the last one recording
    only."""
    cfg, rs = plan.cfg, plan.rs
    src = _check_inputs(plan, lam, mu, rho, stf, src_z, src_x, rxz)
    if save_strips:
        propagator.check_strip_grid(cfg)
    if lam.device.type == "cpu":
        plain = forward_plain_strips if save_strips else forward_plain
        return plain(cfg, rs, lam, mu, rho, stf, *src)
    data, strips, _, fields = _forward_kernel(plan, cfg, lam, mu, rho, stf,
                                              src, save_strips=save_strips)
    if save_strips:
        # the final fields alone, so the double buffer is freed here
        return data, strips, fields[(cfg.nt - 1) % 2].clone()
    return data


@torch.no_grad()
def snapshots_plain(cfg: SimConfig, rs, lam, mu, rho, stf, src_z, src_x, rxz,
                    save_every: int):
    """The plain version of the snapshot route:
    propagator.propagate_snapshots_shots on the survey."""
    count_plain("snapshots_plain")
    geoms = _geoms(cfg, rs, src_z, src_x, rxz, lam.device, lam.dtype)
    return propagator.propagate_snapshots_shots(cfg, lam, mu, rho, stf,
                                                geoms, save_every)


def snapshots_cuda_plan(plan: FastPlan, lam, mu, rho, stf, src_z, src_x,
                        rxz, save_every: int = 10):
    """The forward with wavefield snapshots under a FastPlan
    (`propagator.propagate_snapshots` of every shot): (data (S, 4, n_rec,
    used + 1), snaps (n_chunks, 5, S, nz, nx) in Fields order), n_chunks =
    (nt-1) // save_every, used = n_chunks save_every, snaps[k] the fields
    after (k + 1) save_every steps.  Inputs as for forward_cuda_plan, stf
    (S, nt) of the plan's nt.

    CPU tensors run snapshots_plain; CUDA tensors run the forward kernel
    over used steps, `launches_forward` of
    `propagator.snapshot_config(cfg, save_every)` launches, each snapshot a
    device-to-device copy of the step's state between launches."""
    cfg_s = propagator.snapshot_config(plan.cfg, save_every)
    src = _check_inputs(plan, lam, mu, rho, stf, src_z, src_x, rxz)
    if lam.device.type == "cpu":
        return snapshots_plain(plan.cfg, plan.rs, lam, mu, rho, stf, *src,
                               save_every)
    data, _, snaps, _ = _forward_kernel(plan, cfg_s, lam, mu, rho,
                                        stf[:, :cfg_s.nt].contiguous(), src,
                                        save_every=save_every)
    return data, snaps


def _forward_kernel(plan: FastPlan, cfg: SimConfig, lam, mu, rho, stf, src,
                    save_strips=False, save_every=0):
    """Launch elastic_forward on CUDA tensors over cfg.nt samples (the
    plan's tables, cfg's nt): (data, strips or None, snapshots or None, the
    double buffer of the fields (2, 5, S, nz, nx))."""
    global LAUNCHES, LAUNCHES_STRIPS, LAUNCHES_FIBER
    rs = plan.rs
    device = lam.device
    lib = _load(device)
    S = stf.shape[0]
    with torch.cuda.device(device):
        mats = torch.stack(tuple(material_fields(lam, mu, rho))).contiguous()
        prof_z, prof_x = _profiles(cfg, device)
        rec = plan.receivers(device)
        rec_z, rec_x, rec_w = (None,) * 3 if rec is None else rec[:3]
        tile_ptr, tile_rec, tile = (None, None, TILE) if rec is None \
            else rec[4]
        zeros = lambda *shape: torch.zeros(shape, device=device,
                                           dtype=torch.float32)
        fields = zeros(2, 5, S, cfg.nz, cfg.nx)
        psi = zeros(N_BAND_PLANES * S * band_floats(cfg))
        data = zeros(S, 4, rs.n_rec, cfg.nt)
        empty = lambda *shape: torch.empty(shape, device=device,
                                           dtype=torch.float32)
        strips = (empty(S, cfg.nt - 1, 5, propagator.strip_len(cfg))
                  if save_strips else None)
        snaps = (empty((cfg.nt - 1) // save_every, 5, S, cfg.nz, cfg.nx)
                 if save_every else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        one = np.float32(1.0)
        with spans.span("cuda_engine.forward"):
            err = lib.elastic_forward(
                mats.data_ptr(), prof_z.data_ptr(), prof_x.data_ptr(),
                stf.data_ptr(), *(t.data_ptr() for t in src),
                _ptr(rec_z), _ptr(rec_x), _ptr(rec_w), _ptr(tile_ptr),
                _ptr(tile_rec), fields.data_ptr(), psi.data_ptr(),
                data.data_ptr(), _ptr(strips), _ptr(snaps), save_every, S,
                cfg.nz, cfg.nx, cfg.nt,
                *_row_args(rs), ETT_MODES[cfg.das_channel], *tile, cfg.npml,
                cfg.n_bnd_layers,
                *cpml_bands(cfg), ctypes.c_float(cfg.dt),
                ctypes.c_float(cfg.src_scale * cfg.dt),
                ctypes.c_float(one / np.float32(cfg.dz)),
                ctypes.c_float(one / np.float32(cfg.dx)), stream)
    _raise_on(lib, err, "elastic_forward")
    with COUNT_LOCK:
        LAUNCHES += launches_forward(cfg)
        if save_strips:
            LAUNCHES_STRIPS += launches_forward(cfg)
        if rec is not None and cfg.nt > 1:
            LAUNCHES_FIBER += 1
    return data, strips, snaps, fields


def illumination_cuda_plan(plan: FastPlan, lam, mu, rho, stf, src_z, src_x,
                           rxz):
    """Per-cell source-wavefield energy sum_t (szz + sxx)^2 of every shot
    under a FastPlan (`imaging.source_illumination`'s route on the card):
    (S, nz, nx), masked to the interior.  lam/mu/rho (nz, nx), stf (S, nt),
    src_z/src_x/rxz (S,) on the padded grid.

    CPU tensors run imaging.source_illumination (in their own dtype); CUDA
    tensors (float32, contiguous) run the fused forward step with its
    illumination accumulator, one launch a step and no recording; anything
    else raises."""
    global LAUNCHES_ILL
    cfg = plan.cfg
    if lam.device.type == "cpu":
        # imported here: imaging imports this module's PLAIN_CALLS
        from sep2023_tpu_torch import imaging
        geoms = _geoms(cfg, plan.rs, src_z, src_x, rxz, lam.device,
                       lam.dtype)
        return imaging.source_illumination(cfg, lam, mu, rho, stf, geoms)
    src = _check_inputs(plan, lam, mu, rho, stf, src_z, src_x, rxz)
    device = lam.device
    lib = _load(device)
    S = stf.shape[0]
    with torch.cuda.device(device):
        mats = torch.stack(tuple(material_fields(lam, mu, rho))).contiguous()
        prof_z, prof_x = _profiles(cfg, device)
        zeros = lambda *shape: torch.zeros(shape, device=device,
                                           dtype=torch.float32)
        fields = zeros(2, 5, S, cfg.nz, cfg.nx)
        psi = zeros(N_BAND_PLANES * S * band_floats(cfg))
        ill = zeros(S, cfg.nz, cfg.nx)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.elastic_illumination(
            mats.data_ptr(), prof_z.data_ptr(), prof_x.data_ptr(),
            stf.data_ptr(), *(t.data_ptr() for t in src),
            fields.data_ptr(), psi.data_ptr(), ill.data_ptr(),
            S, cfg.nz, cfg.nx, cfg.nt, *cpml_bands(cfg),
            ctypes.c_float(cfg.dt), ctypes.c_float(cfg.src_scale * cfg.dt),
            stream)
    _raise_on(lib, err, "elastic_illumination")
    with COUNT_LOCK:
        LAUNCHES_ILL += cfg.nt - 1
    mz, mx = propagator._interior_mask(cfg, device=device,
                                       dtype=torch.float32)
    return ill * (mz * mx)


def _backward_kernel(plan: FastPlan, lam, mu, rho, stf, src, final, strips,
                     d_data):
    """Launch elastic_backward on CUDA tensors: (gmat (5, nz, nx), d_stf
    (S, nt), fields reconstructed at t=0 (5, S, nz, nx))."""
    global LAUNCHES_BWD
    cfg, rs = plan.cfg, plan.rs
    device = lam.device
    lib = _load(device)
    S = stf.shape[0]
    with torch.cuda.device(device):
        mats = torch.stack(tuple(material_fields(lam, mu, rho))).contiguous()
        prof_z, prof_x = _profiles(cfg, device)
        rec = plan.receivers(device)
        table = (None,) * 6 if rec is None else rec[3]
        tile_ptr, tile_inj, tile = (None, None, TILE) if rec is None \
            else rec[5]
        zeros = lambda *shape: torch.zeros(shape, device=device,
                                           dtype=torch.float32)
        fields = torch.empty((2, 5, S, cfg.nz, cfg.nx), device=device,
                             dtype=torch.float32)
        fields[0].copy_(final)
        work = zeros(N_WORK_PLANES, S, cfg.nz, cfg.nx)
        psi = zeros(N_BAND_PLANES * S * band_floats(cfg))
        gshot = zeros(S, N_GRAD_PLANES, cfg.nz, cfg.nx)
        gmat = torch.empty((N_GRAD_PLANES, cfg.nz, cfg.nx), device=device,
                           dtype=torch.float32)
        d_stf = zeros(S, cfg.nt)
        stream = torch.cuda.current_stream(device).cuda_stream
        with spans.span("cuda_engine.backward"):
            err = lib.elastic_backward(
                mats.data_ptr(), prof_z.data_ptr(), prof_x.data_ptr(),
                stf.data_ptr(), *(t.data_ptr() for t in src),
                strips.data_ptr(), d_data.data_ptr(),
                *(_ptr(t) for t in table),
                _ptr(tile_ptr), _ptr(tile_inj), fields.data_ptr(),
                work.data_ptr(), psi.data_ptr(),
                gshot.data_ptr(), gmat.data_ptr(), d_stf.data_ptr(),
                S, cfg.nz, cfg.nx, cfg.nt, *_row_args(rs),
                ETT_MODES[cfg.das_channel], *tile, cfg.npml,
                cfg.n_bnd_layers, *cpml_bands(cfg), ctypes.c_float(cfg.dt),
                ctypes.c_float(cfg.src_scale * cfg.dt), stream)
    _raise_on(lib, err, "elastic_backward")
    with COUNT_LOCK:
        LAUNCHES_BWD += launches_backward(cfg, rs)
    return gmat, d_stf, fields[(cfg.nt - 1) % 2]


def backward_cuda_plan(plan: FastPlan, lam, mu, rho, stf, src_z, src_x, rxz,
                       final, strips, d_data):
    """The boundary-saving adjoint of all shots under a FastPlan.  final
    (5, S, nz, nx) and strips come from forward_cuda_plan(save_strips=True);
    d_data (S, 4, n_rec, nt) is the data cotangent.  Returns (d_lam, d_mu,
    d_rho, d_stf): the kernel's material-field gradients kept inside the
    interior and chained through material_fields by autograd, as
    _run_backward does.

    CPU tensors run backward_plain; CUDA tensors run the kernel, at any
    grid size."""
    src = _check_inputs(plan, lam, mu, rho, stf, src_z, src_x, rxz)
    _check_residuals(plan, lam, stf, final, strips, d_data)
    cfg = plan.cfg
    if lam.device.type == "cpu":
        return backward_plain(cfg, plan.rs, lam, mu, rho, stf, *src, final,
                              strips, d_data)
    gmat, d_stf, _ = _backward_kernel(plan, lam, mu, rho, stf, src, final,
                                      strips, d_data)
    gmat = propagator.MatFields(*gmat)
    return (*propagator.material_grads(cfg, lam, mu, rho, gmat), d_stf)


def reconstruct_cuda_plan(plan: FastPlan, lam, mu, rho, stf, src_z, src_x,
                          rxz, final, strips):
    """The backward kernel's reconstruction alone, driven with a zero data
    cotangent: the fields (5, S, nz, nx) rebuilt back to t=0.  CUDA
    tensors only; reconstruct_plain is its plain version."""
    src = _check_inputs(plan, lam, mu, rho, stf, src_z, src_x, rxz)
    d_data = torch.zeros((stf.shape[0], 4, plan.rs.n_rec, plan.cfg.nt),
                         device=lam.device, dtype=torch.float32)
    _check_residuals(plan, lam, stf, final, strips, d_data)
    return _backward_kernel(plan, lam, mu, rho, stf, src, final, strips,
                            d_data)[2]


class _PropagateCuda(torch.autograd.Function):
    """forward_cuda_plan with strip saving, and the backward kernel as its
    backward: the counterpart of propagate_pallas's custom_vjp
    (_pp_fwd/_pp_bwd)."""

    @staticmethod
    def forward(ctx, plan, src_z, src_x, rxz, lam, mu, rho, stf):
        if not any(ctx.needs_input_grad[4:]):
            return forward_cuda_plan(plan, lam, mu, rho, stf, src_z, src_x,
                                     rxz)
        data, strips, final = forward_cuda_plan(plan, lam, mu, rho, stf,
                                                src_z, src_x, rxz,
                                                save_strips=True)
        ctx.args = (plan, src_z, src_x, rxz)
        ctx.save_for_backward(lam, mu, rho, stf, final, strips)
        return data

    @staticmethod
    def backward(ctx, d_data):
        plan, src_z, src_x, rxz = ctx.args
        lam, mu, rho, stf, final, strips = ctx.saved_tensors
        grads = backward_cuda_plan(plan, lam, mu, rho, stf, src_z, src_x, rxz,
                               final, strips, d_data.contiguous())
        return (None,) * 4 + tuple(grads)


def propagate_cuda_plan(plan: FastPlan, lam, mu, rho, stf, src_z, src_x,
                        rxz):
    """Differentiable all-shots propagator under a FastPlan (the
    counterpart of `propagate_pallas_plan`): data (S, 4, n_rec, nt), with
    gradients of lam, mu, rho and stf by the boundary-saving adjoint.
    float32 only: CUDA tensors run the kernels, at any grid size, CPU
    tensors their plain versions; anything else raises."""
    if lam.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA kernels compute in float32, not {lam.dtype}; the "
            "plain propagator (propagator.propagate_shots) runs other "
            "dtypes on the CPU")
    return _PropagateCuda.apply(plan, src_z, src_x, rxz,
                                lam.contiguous(), mu.contiguous(),
                                rho.contiguous(), stf.contiguous())
