"""Problem builders and comparisons shared by the GPU tests and
chip_smoke.py, so both hold the CUDA kernels against their plain versions
on the same cases with the same tolerances."""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from sep2023_tpu_torch import api, cli, das, models
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine
from sep2023_tpu_torch.ops.misfit import residual

# row_problem arguments of the kernel-vs-plain cases that chip_smoke.py and
# tests/test_torch_cuda.py both run (forward, strips, gradient).
ROW_CASES = {
    "small exx": (44, 60, 10, 260, 2, 38, "exx"),
    "small ezz": (44, 60, 10, 260, 2, 38, "ezz"),
    "reference shape nt=301": (101, 201, 32, 301, 19, 40, "exx"),
}

# fiber_problem arguments of the point-receiver cases that chip_smoke.py
# and tests/test_torch_cuda.py both run: (das_channel, spacing, dt, f0).
# The receivers of each are built in `_fiber_receivers`.
FIBER_CASES = {
    "arc weighted": ("weighted", 10.0, 0.001, 15.0),
    "column ezz": ("ezz", 20.0, 0.002, 10.0),
    "duplicate points exx": ("exx", 20.0, 0.002, 10.0),
}

# Acoustic kernel-vs-plain cases that chip_smoke.py and
# tests/test_torch_cuda.py both run, on the 44x60 grid (npml 10, nt=260,
# 2 shots): physical-grid (rec_z, rec_x) of a row, of points that visit a
# cell several times, and of a column.
AC_CASES = {
    "row": (np.full(40, 38), np.arange(10, 50)),
    "duplicate points": (np.array([30] * 16 + [31] * 6),
                         np.array(list(range(14, 26)) + [25] * 4
                                  + list(range(18, 24)))),
    "column": (np.arange(8, 34), np.full(26, 48)),
}
# The acoustic gradients are kept on the tight interior [npml+2, n-3-npml]
# (acoustic._consts); kernel and plain are compared on it shrunk by
# GRAD_MARGIN, for the same reason as the elastic ones.
AC_INTERIOR = 2

# Cases that put the edges of the fused kernels' tiles (kTileZ x kTileX =
# 16 x 32 cells, csrc/elastic_common.cuh) where a race or a halo fault
# would show: grid sides that are not multiples of the tile, a grid smaller
# than one tile, a CPML band wider than a tile, and sources, a receiver
# row's first and last receiver and fiber points on the cells either side
# of a tile edge, one case with some cells visited two to four times
# (each receiver records its own sample in the tile that owns its cell),
# and one with points on the last cell inside a neighbour tile's 2-cell
# halo and the first cell outside it (the backward adds a vz or vx
# cotangent in every tile whose velocity phase reads its cell).
# Each: (physical nz, nx, npml, nt, das_channel, padded (src_z, src_x) of
# each shot, receivers): receivers ("row", rec_row, rec_x0, n_rec) or
# ("points", rec_z, rec_x) with the weighted channel's weights (1, 0.5,
# 0.25), or ("points", rec_z, rec_x, weights) with weights of their own,
# all padded-grid indices.  20 m, 2 ms, 10 Hz.  Their adjoint test draws from
# TILE_EDGE_SEED: seed 7's random pair nearly cancels on the sources-on-edges
# case (<d, J s> = 15.9 where its terms are about 6e4), so that even the
# plain versions' relative gap there is 1.6e-3.
_EDGES_Z, _EDGES_X = (15, 16, 31, 32, 47, 48), (31, 32, 63, 64)
TILE_EDGE_SEED = 8
# every edge cell once, then (15, 31), (15, 32) and (16, 31) again and
# (48, 64) three times more
_DUP_Z = np.concatenate([np.repeat(_EDGES_Z, len(_EDGES_X)),
                         [15, 15, 16, 48, 48, 48]])
_DUP_X = np.concatenate([np.tile(_EDGES_X, len(_EDGES_Z)),
                         [31, 32, 31, 64, 64, 64]])
# either side of the tile edges at z = 16 and x = 32: rows 14 and 17 and
# columns 30 and 33 are the last inside the neighbour's 2-cell halo, rows
# 13 and 18 and columns 29 and 34 the first outside it; then (14, 30) twice
# more and (17, 33) once more
_HALO_Z, _HALO_X = (13, 14, 17, 18), (29, 30, 33, 34)
_HALO_PZ = np.concatenate([np.repeat(_HALO_Z, len(_HALO_X)), [14, 14, 17]])
_HALO_PX = np.concatenate([np.tile(_HALO_X, len(_HALO_Z)), [30, 30, 33]])
TILE_EDGE_CASES = {
    "ragged tiles": (45, 61, 10, 260, "exx", ((11, 20), (11, 60)),
                     ("row", 48, 20, 41)),
    "grid under one tile": (8, 20, 3, 200, "ezz", ((4, 8), (4, 17)),
                            ("row", 8, 4, 18)),
    "band wider than a tile": (30, 50, 40, 260, "exx", ((41, 60), (41, 90)),
                               ("row", 60, 45, 40)),
    "source and row ends on tile edges": (
        44, 76, 10, 260, "exx", ((16, 32), (15, 63), (32, 31)),
        ("row", 48, 32, 32)),
    "fiber points on tile edges": (
        44, 76, 10, 260, "weighted", ((11, 40), (11, 70)),
        ("points", np.repeat(_EDGES_Z, len(_EDGES_X)),
         np.tile(_EDGES_X, len(_EDGES_Z)))),
    # weights of each receiver's own, so that two receivers of one cell
    # record different samples
    "duplicate points on tile edges": (
        44, 76, 10, 260, "weighted", ((11, 40), (11, 70)),
        ("points", _DUP_Z, _DUP_X,
         np.random.default_rng(TILE_EDGE_SEED).uniform(
             0.25, 1.0, (len(_DUP_Z), 3)))),
    "points by a neighbour's halo": (
        44, 76, 10, 260, "weighted", ((11, 40), (11, 70)),
        ("points", _HALO_PZ, _HALO_PX,
         np.random.default_rng(TILE_EDGE_SEED + 1).uniform(
             0.25, 1.0, (len(_HALO_PZ), 3)))),
}


# The same for the fused acoustic kernels (csrc/acoustic_fwd.cu,
# csrc/acoustic_bwd.cu, on the same tiles): grid sides that are not
# multiples of the tile, a grid under one tile, a CPML band wider than a
# tile, sources and a receiver row's first and last receivers on tile edges,
# point receivers on the cells either side of tile edges with some of them
# visited two to four times, and point receivers either side of a
# neighbour's 2-cell halo.  Each: (physical nz, nx, npml, nt, padded
# (src_z, src_x) of each shot, receivers ("row", rec_row, rec_x0, n_rec) or
# ("points", rec_z, rec_x)), padded-grid indices; 20 m, 2 ms, 10 Hz, the
# anomaly model with lam = rho vp^2 (acoustic_args).  On each the tight
# interior shrunk by AC_INTERIOR + GRAD_MARGIN cells, where the gradients
# are compared, holds cells.  The adjoint test draws from TILE_EDGE_SEED.
AC_TILE_EDGE_CASES = {
    "ragged tiles": (45, 61, 10, 260, ((11, 20), (11, 60)),
                     ("row", 48, 20, 41)),
    "grid under one tile": (9, 22, 3, 200, ((4, 8), (4, 18)),
                            ("row", 9, 4, 20)),
    "band wider than a tile": (30, 50, 40, 260, ((41, 60), (41, 90)),
                               ("row", 60, 45, 40)),
    "source and row ends on tile edges": (
        44, 76, 10, 260, ((16, 32), (15, 63), (32, 31)),
        ("row", 48, 32, 32)),
    "duplicate points on tile edges": (
        44, 76, 10, 260, ((11, 40), (11, 70)),
        ("points", _DUP_Z, _DUP_X)),
    "points by a neighbour's halo": (
        44, 76, 10, 260, ((11, 40), (11, 70)),
        ("points", _HALO_PZ, _HALO_PX)),
}


def ac_tile_edge_problem(name, *, device):
    """An AC_TILE_EDGE_CASES case: (cfg, RowSurvey or FiberSurvey, args)
    with args the inputs of forward_cuda_acoustic_plan after the plan."""
    nz, nx, npml, nt, src, rec = AC_TILE_EDGE_CASES[name]
    src_z, src_x = (np.array(a) for a in zip(*src))
    cfg, args = _problem(nz, nx, npml, nt, len(src_z), "exx", 20.0, 0.002,
                         10.0, device)
    args = acoustic_args((*args[:4], src_z, src_x, None))
    if rec[0] == "row":
        return cfg, cuda_engine.RowSurvey(*rec[1:]), args
    return cfg, cuda_engine.make_fiber_survey(*rec[1:]), args


def tile_edge_problem(name, *, device):
    """A TILE_EDGE_CASES case: (cfg, RowSurvey or FiberSurvey, args)."""
    nz, nx, npml, nt, channel, src, rec = TILE_EDGE_CASES[name]
    src_z, src_x = (np.array(a) for a in zip(*src))
    cfg, args = _problem(nz, nx, npml, nt, len(src_z), channel, 20.0, 0.002,
                         10.0, device)
    args = (*args[:4], src_z, src_x, np.ones(len(src_z)))
    if rec[0] == "row":
        return cfg, cuda_engine.RowSurvey(*rec[1:]), args
    rec_z, rec_x = rec[1:3]
    das_w = rec[3] if len(rec) > 3 else np.tile([1.0, 0.5, 0.25],
                                                (len(rec_z), 1))
    return cfg, cuda_engine.make_fiber_survey(rec_z, rec_x, das_w), args


# Kernel vs plain, float32 both.  Forward data: per channel, relative to the
# channel max (the JAX package's Pallas-vs-XLA bound); strips and final
# fields: per field, relative to the field max.
FWD_TOL = 2e-5
# Gradients: relative to the max abs of each gradient, the JAX package's
# Pallas-vs-XLA gradient bound (tests/test_pallas_engine.py:166), on the
# interior shrunk by GRAD_MARGIN cells as there: at the interior's edge the
# kernel takes the velocity phase's stencils of the carried (exact) stresses,
# as the Pallas kernel does, where the plain version's autograd of the step
# recomputes them from zero CPML memory.
GRAD_TOL = 5e-4
GRAD_MARGIN = 2
# Adjoint identity <d, J s> = <J^T d, s> in the source wavelet (float32),
# the bound of test_pallas_adjoint_dot_product.
DOT_TOL = 5e-5
# The kernel's f32 reconstruction residual may be at most this multiple of
# the plain f32 version's on the same final fields and strips.
RECON_RATIO = 10.0


def _problem(nz, nx, npml, nt, n_shots, das_channel, dh, dt, f0, device):
    """Anomaly model on an nz x nx physical grid, shots along z=1, float32:
    (cfg, args) with args the padded-grid inputs of
    forward_cuda_plan/forward_plain after the plan or the survey."""
    cfg = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=dh, dx=dh,
                    nt=nt, dt=dt, f0=f0, npml=npml, das_channel=das_channel)
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    t = lambda a: torch.as_tensor(pad_model_np(a, npml), device=device
                                  ).to(torch.float32)
    lam, mu, rho = Medium(t(vp), t(vs), t(rho)).to_lame()
    stf = torch.as_tensor(ricker(f0, nt, dt), device=device
                          ).to(torch.float32).expand(n_shots, nt).contiguous()
    src_x = np.linspace(10, nx - 10, n_shots).astype(int) + npml
    return cfg, (lam.contiguous(), mu.contiguous(), rho.contiguous(), stf,
                 np.full(n_shots, 1 + npml), src_x, np.ones(n_shots))


def row_problem(nz, nx, npml, nt, n_shots, rec_z, das_channel="exx", *,
                device):
    """`_problem` at 20 m, 2 ms, 10 Hz with one receiver row at rec_z
    (physical grid): (cfg, rs, args)."""
    cfg, args = _problem(nz, nx, npml, nt, n_shots, das_channel, 20.0, 0.002,
                         10.0, device)
    return cfg, cuda_engine.RowSurvey(rec_z + npml, 10 + npml, nx - 20), args


def _fiber_receivers(name, dh):
    """Physical-grid (rec_z, rec_x, das_w or None) of a FIBER_CASES case."""
    if name == "arc weighted":
        # two arc cables of 21 points 20 m apart: neighbouring points share
        # cells, and the second cable's samples overlap the first's
        cables = [das.arc_fiber(80.0, 2.0 / np.pi, center=(cx, 200.0, 0.0))
                  for cx in (260.0, 280.0)]
        parts = [das.cable_to_receivers(c, dh, dh) for c in cables]
        return tuple(np.concatenate(p) for p in zip(*parts))
    if name == "column ezz":
        return np.arange(8, 34), np.full(26, 48), None
    if name == "duplicate points exx":
        # a row spread that visits its last cell 4 more times and a second
        # row below it (the JAX package's duplicate-lane cables)
        rec_z = np.array([30] * 16 + [31] * 6)
        rec_x = np.array(list(range(14, 26)) + [25] * 4
                         + list(range(18, 24)))
        return rec_z, rec_x, None
    raise KeyError(name)


def fiber_problem(name, *, device):
    """A FIBER_CASES case on the 44x60 grid (npml 10, nt=260, 2 shots):
    (cfg, FiberSurvey, args)."""
    das_channel, dh, dt, f0 = FIBER_CASES[name]
    npml = 10
    cfg, args = _problem(44, 60, npml, 260, 2, das_channel, dh, dt, f0,
                         device)
    rec_z, rec_x, das_w = _fiber_receivers(name, dh)
    return cfg, cuda_engine.make_fiber_survey(rec_z + npml, rec_x + npml,
                                              das_w), args


def doubling_cable():
    """A 64x96 grid and a cable along row 30 from x=20 to 44 that turns
    back along the same cells to x=30, then drops to row 31: its cells from
    x=30 to 43 hold two receivers each, across the tile edge at x=32.
    (cfg, FiberSurvey), padded-grid indices."""
    cfg = SimConfig(nz=64, nx=96, dz=20.0, dx=20.0, nt=11, dt=0.002,
                    f0=10.0, npml=10)
    rec_x = np.concatenate([np.arange(20, 45), np.arange(43, 29, -1),
                            np.arange(30, 36)])
    rec_z = np.concatenate([np.full(25 + 14, 30), np.full(6, 31)])
    return cfg, cuda_engine.make_fiber_survey(rec_z, rec_x)


def acoustic_args(args):
    """The acoustic inputs (lam = rho vp^2, rho, stf, src_z, src_x) of the
    elastic inputs `args` of `_problem`: the same vp and rho."""
    lam, mu, rho, stf, src_z, src_x, _ = args
    return (lam + 2.0 * mu).contiguous(), rho, stf, src_z, src_x


def ac_row_problem(nz, nx, npml, nt, n_shots, rec_z, *, device):
    """`row_problem` for the acoustic kernels: (cfg, RowSurvey, args) with
    args the inputs of forward_cuda_acoustic_plan after the plan."""
    cfg, rs, args = row_problem(nz, nx, npml, nt, n_shots, rec_z,
                                device=device)
    return cfg, rs, acoustic_args(args)


def ac_fiber_problem(rec_z, rec_x, *, device):
    """Point receivers at physical-grid (rec_z, rec_x) on the 44x60 grid
    (npml 10, nt=260, 2 shots): (cfg, FiberSurvey, args)."""
    npml = 10
    cfg, args = _problem(44, 60, npml, 260, 2, "exx", 20.0, 0.002, 10.0,
                         device)
    return cfg, cuda_engine.make_fiber_survey(rec_z + npml, rec_x + npml), \
        acoustic_args(args)


def ac_problem(name, *, device):
    """An AC_CASES case: the row as a RowSurvey, the others as points."""
    rec_z, rec_x = AC_CASES[name]
    if name == "row":
        return ac_row_problem(44, 60, 10, 260, 2, int(rec_z[0]),
                              device=device)
    return ac_fiber_problem(rec_z, rec_x, device=device)


def ac_perturbed_cotangent(cfg, rs, args, syn):
    """The data cotangent of 0.5 sum((obs - syn)^2) over the three acoustic
    channels, sample 0 zeroed, against the data of the model with lam raised
    by 3% (forward_cuda_acoustic_plan on the tensors' device)."""
    lam, rho, stf, src_z, src_x = args
    obs = cuda_acoustic.forward_cuda_acoustic_plan(
        cuda_engine.plan_for(cfg, rs), (lam * 1.03).contiguous(), rho, stf,
        src_z, src_x)
    return -residual(obs, syn)


def perturbed_cotangent(cfg, rs, args, syn):
    """The data cotangent of the default L2 misfit on ett (0.5 sum((obs -
    syn)^2), sample 0 zeroed: -(obs - syn) on ett) against the data of the
    model with lam raised by 3% (forward_cuda_plan on the tensors'
    device)."""
    lam, mu, rho, stf, src_z, src_x, rxz = args
    obs = cuda_engine.forward_cuda_plan(
        cuda_engine.plan_for(cfg, rs), (lam * 1.03).contiguous(), mu, rho,
        stf, src_z, src_x, rxz)
    d = torch.zeros_like(syn)
    d[:, 3] = -residual(obs, syn)[:, 3]
    return d


def max_rel(out, ref) -> float:
    """max |out - ref| / max |ref|; 0 when both are all zero."""
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    return err / scale if scale > 0 else err


def strip_errors(out, ref):
    """Kernel vs plain forward with strip saving, out and ref each (data,
    strips, final): (max_rel per data channel, per strip field, per final
    field), each relative to that channel's or field's max."""
    (d, s, f), (dr, sr, fr) = out, ref
    return ([max_rel(d[:, c], dr[:, c]) for c in range(d.shape[1])],
            [max_rel(s[:, :, k], sr[:, :, k]) for k in range(s.shape[2])],
            [max_rel(f[k], fr[k]) for k in range(f.shape[0])])


def reconstruction_residual(cfg: SimConfig, f0, data) -> float:
    """The stresses reconstructed back to t=0 should be zero: their max
    |value| over the interior, relative to the peak |pr| recorded (the
    measure of the JAX package's tests/test_reconstruction.py).  Of the
    acoustic fields (3, S, nz, nx) the pressure."""
    n = cfg.npml
    stress = f0[2:] if f0.shape[0] == 5 else f0[:1]
    inner = stress[:, :, n:cfg.nz - n, n:cfg.nx - n]
    return float(inner.abs().max() / data[:, 0].abs().max())


def grad_errors(out, ref, cfg: SimConfig, interior: int = 0):
    """max_rel of each gradient of (d_lam, d_mu, d_rho, d_stf) or of the
    acoustic (d_lam, d_rho, d_stf): the model gradients on the interior
    (which starts `interior` cells inside the PML: AC_INTERIOR for the
    acoustic ones) shrunk by GRAD_MARGIN, d_stf whole."""
    m = cfg.npml + interior + GRAD_MARGIN
    sl = (slice(m, cfg.nz - m), slice(m, cfg.nx - m))
    return [max_rel(a[sl], b[sl]) for a, b in zip(out[:-1], ref[:-1])] + \
        [max_rel(out[-1], ref[-1])]


def adjoint_gap(cfg, rs, args, seed=7):
    """<d, J s> against <J^T d, s> through cuda_engine.propagate_cuda_plan
    (with the 5 acoustic inputs of `acoustic_args`:
    cuda_acoustic.propagate_cuda_acoustic_plan), with J the (linear) map
    from the source wavelets to the data and s, d random from `seed`:
    returns (lhs, rhs, |lhs - rhs| / |lhs|)."""
    is_acoustic = len(args) == 5
    stf = args[2] if is_acoustic else args[3]
    rng = np.random.default_rng(seed)
    dev = stf.device
    s = torch.as_tensor(rng.standard_normal(stf.shape), device=dev
                        ).to(torch.float32).requires_grad_()
    d = torch.as_tensor(rng.standard_normal(
        (stf.shape[0], 3 if is_acoustic else 4, rs.n_rec, cfg.nt)),
        device=dev).to(torch.float32)
    plan = cuda_engine.plan_for(cfg, rs)
    if is_acoustic:
        data = cuda_acoustic.propagate_cuda_acoustic_plan(
            plan, *args[:2], s, *args[3:])
    else:
        data = cuda_engine.propagate_cuda_plan(plan, *args[:3], s, *args[4:])
    lhs = float((d.double() * data.detach().double()).sum())
    (g,) = torch.autograd.grad(data, s, d)
    rhs = float((g.double() * s.detach().double()).sum())
    return lhs, rhs, abs(lhs - rhs) / abs(lhs)


# The plain engine on another device than the CPU against the CPU, float64
# (the JAX package's XLA engine on its accelerator): `invert` at the CPU
# tests' tiny size, and ElasticPropagator on the API's small problem.
TINY_INVERT = ["--nz", "28", "--nx", "48", "--nt", "80", "--npml", "8",
               "--niter", "2"]
PLAIN_DEVICE_TOL = 1e-9
# The same in float32, where a survey no plan takes runs on the plain engine
# (`invert --engine xla`, ElasticPropagator(dtype=torch.float32,
# engine='xla')): loss.txt, the model, the data and each gradient relative
# to its max.  In float32 TINY_INVERT's first L-BFGS-B step is below float32
# resolution (0 iterations, no loss.txt), so float32 `invert` runs at
# CORNER_INVERT.
PLAIN_F32_DEVICE_TOL = 1e-6
CORNER_INVERT = ["--nz", "44", "--nx", "64", "--nt", "200", "--npml", "8",
                 "--niter", "2"]


def corner_survey(nz: int = 28, nx: int = 48, npml: int = 8,
                  src_x=(10, 20, 30)) -> Survey:
    """A survey no plan of the kernels takes, by default at TINY_INVERT's
    grid: a shot at z = 1 at each src_x, the receiver row at z = nz - 6
    from x = 10 to nx - 11 (the reference survey's at 101x201), and the
    padded grid's two far corners."""
    return Survey(src_z=np.ones(len(src_x), int), src_x=np.asarray(src_x),
                  rec_z=np.array([nz - 6] * (nx - 20) + [-npml,
                                                          nz + npml - 1]),
                  rec_x=np.array(list(range(10, nx - 10))
                                 + [-npml, nx + npml - 1]))


def repeated_shot_mesh(n_devices=None, *, device, n_shots=None):
    """`parallel.shot_mesh` with the device count taken as n_devices: the
    mesh repeats `device`, as k CPU shards repeat the CPU, so that `invert
    --n-devices k` shards over one card; None for one shard."""
    n = min(n_devices or 1, n_shots or n_devices or 1)
    return (torch.device(device),) * n if n > 1 else None


def corner_api_problem():
    """(Model, Survey, initial Model) of the API on `corner_survey`: the
    anomaly model at TINY_INVERT's grid (dz = dx = 20, nt = 80, dt =
    0.002, the CLI's defaults) and vp 3000 everywhere to start from."""
    nz, nx = 28, 48
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    model = api.Model(nx=nx, nz=nz, dx=20.0, dz=20.0, nt=80, dt=0.002,
                      nPml=8, vp=vp, vs=vs, rho=rho)
    init = api.Model(**{**model.__dict__, "vp": np.full_like(vp, 3000.0)})
    return model, corner_survey(), init


def invert_run(argv, exp):
    """(loss.txt (n, 2), the last Results/model_*.npz as a dict, summary)
    of `invert *argv --exp-name exp`."""
    out = cli.main(["invert", *argv, "--exp-name", exp])
    hist = np.loadtxt(os.path.join(exp, "Results", "loss.txt"), ndmin=2)
    snap = sorted(glob.glob(os.path.join(exp, "Results", "model_*.npz")))
    with np.load(snap[-1]) as z:
        model = {k: z[k] for k in z.files}
    return hist, model, out


def rel_diff(a, b) -> float:
    """max |a - b| / max |b| (0 when both are 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a).max())


def api_problem():
    """(Model, Survey) of the API's small problem (44x60, npml 10, nt=260,
    2 shots, a receiver row) and its initial model (vp 3000 everywhere)."""
    nz, nx = 44, 60
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    model = api.Model(nx=nx, nz=nz, dx=20.0, dz=20.0, nt=260, dt=0.002,
                      nPml=10, vp=vp, vs=vs, rho=rho)
    survey = Survey(src_z=np.array([1, 1]), src_x=np.array([15, 45]),
                    rec_z=np.full(40, 38), rec_x=np.arange(10, 50))
    init = api.Model(**{**model.__dict__, "vp": np.full_like(vp, 3000.0)})
    return model, survey, init
