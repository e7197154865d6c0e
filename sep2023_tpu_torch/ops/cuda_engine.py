"""Fused elastic forward engine on the GPU: the hand-written CUDA kernel
`csrc/elastic_fwd.cu` and its plain PyTorch version.

Counterpart of `sep2023_tpu/ops/pallas_engine.py::forward_pallas` (the K1
Pallas kernel without strip saving) with the same signature and output,
data (S, 4, n_rec, nt) float32 for a row survey.

`forward_cuda` takes `forward_plain` only for tensors that lie on the CPU.
On CUDA tensors it launches the kernel or raises: it never drops to the
plain version or to the CPU.  `LAUNCHES` counts the kernel launches, so a
run can show that its forward went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from sep2023_tpu_torch import cpml as cpml_mod
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.medium import material_fields
from sep2023_tpu_torch.ops import _build
from sep2023_tpu_torch.propagator import ShotGeom, propagate_shots

# Kernel launches made by forward_cuda: 3 per time step (stress, velocity,
# record).  Read and reset by callers that check the path they ran.
LAUNCHES = 0

N_STATE_PLANES = 13  # 5 fields + 8 CPML psi


class RowSurvey(NamedTuple):
    """Receivers on one grid row with contiguous x (the reference's
    surveyGen layout, fwi_utils.py:87-124), padded-grid indices."""

    rec_row: int
    rec_x0: int
    n_rec: int


def check_row_survey(rec_z, rec_x) -> RowSurvey | None:
    rec_z = np.asarray(rec_z)
    rec_x = np.asarray(rec_x)
    if (rec_z == rec_z[0]).all() and (np.diff(rec_x) == 1).all():
        return RowSurvey(int(rec_z[0]), int(rec_x[0]), len(rec_x))
    return None


def _host_index(a, name: str, hi: int, S: int) -> torch.Tensor:
    a = torch.as_tensor(a).to("cpu", torch.int64).reshape(-1)
    if a.shape != (S,):
        raise ValueError(f"{name} must be ({S},), got {tuple(a.shape)}")
    if int(a.min()) < 0 or int(a.max()) >= hi:
        raise ValueError(f"{name} outside [0, {hi}): {a.tolist()}")
    return a


def _check_inputs(cfg: SimConfig, rs, lam, mu, rho, stf, src_z, src_x, rxz):
    """Validate everything the kernel would otherwise read out of bounds;
    returns (src_z, src_x, rxz) as host int64 / float tensors."""
    if not isinstance(rs, RowSurvey):
        raise NotImplementedError(
            f"forward_cuda takes a RowSurvey; got {type(rs).__name__} "
            "(FiberSurvey recording is ROADMAP K1-fiber)")
    if cfg.das_channel not in ("exx", "ezz"):
        raise NotImplementedError(
            f"das_channel {cfg.das_channel!r} is not in the kernel yet "
            "(weighted fiber recording is ROADMAP K1-fiber)")
    device = lam.device
    for name, t in (("lam", lam), ("mu", mu), ("rho", rho), ("stf", stf)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, lam on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("lam", lam), ("mu", mu), ("rho", rho)):
        if tuple(t.shape) != (cfg.nz, cfg.nx):
            raise ValueError(f"{name} must be ({cfg.nz}, {cfg.nx}), "
                             f"got {tuple(t.shape)}")
    if stf.ndim != 2 or stf.shape[1] != cfg.nt:
        raise ValueError(f"stf must be (S, {cfg.nt}), got {tuple(stf.shape)}")
    S = stf.shape[0]
    if not 1 <= S <= 65535:
        raise ValueError(f"{S} shots: the kernel takes 1..65535")
    lo_z = 1 if cfg.das_channel == "ezz" else 0
    lo_x = 1 if cfg.das_channel == "exx" else 0
    if not (lo_z <= rs.rec_row < cfg.nz and lo_x <= rs.rec_x0
            and rs.n_rec >= 1 and rs.rec_x0 + rs.n_rec <= cfg.nx):
        raise ValueError(f"{rs} does not fit the {cfg.nz}x{cfg.nx} grid "
                         f"with das_channel {cfg.das_channel!r}")
    src_z = _host_index(src_z, "src_z", cfg.nz, S)
    src_x = _host_index(src_x, "src_x", cfg.nx, S)
    rxz = torch.as_tensor(rxz).to("cpu", torch.float32).reshape(-1)
    if rxz.shape != (S,):
        raise ValueError(f"rxz must be ({S},), got {tuple(rxz.shape)}")
    return src_z, src_x, rxz


def forward_plain(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                  src_z, src_x, rxz):
    """The plain PyTorch version of the kernel: propagator.propagate_shots
    on the row survey, on the tensors' own device."""
    device = lam.device
    S = stf.shape[0]
    rec_x = torch.arange(rs.rec_x0, rs.rec_x0 + rs.n_rec, device=device)
    geoms = ShotGeom(
        src_z=torch.as_tensor(src_z).to(device, torch.int64).reshape(S),
        src_x=torch.as_tensor(src_x).to(device, torch.int64).reshape(S),
        rxz=torch.as_tensor(rxz).to(device, lam.dtype).reshape(S),
        rec_z=torch.full((S, rs.n_rec), rs.rec_row, device=device),
        rec_x=rec_x.expand(S, rs.n_rec))
    return propagate_shots(cfg, lam, mu, rho, stf, geoms)


@functools.lru_cache(maxsize=8)
def _profiles(cfg: SimConfig, device: torch.device):
    """(6, nz) and (6, nx) float32 CPML profile rows in cpml.CpmlScaled
    order (ik, a, b, ik_h, a_h, b_h), built in float64 and cast.  Built
    once per (cfg, device); the kernel only reads them."""
    cp = cpml_mod.cpml_scaled(cfg.nz, cfg.nx, cfg.npml, cfg.dz, cfg.dx,
                              cfg.dt, cfg.f0, dtype=np.float32)
    pz = np.stack([p.reshape(-1) for p in cp[:6]])
    px = np.stack([p.reshape(-1) for p in cp[6:]])
    return (torch.from_numpy(pz).to(device), torch.from_numpy(px).to(device))


def forward_cuda(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                 src_z, src_x, rxz):
    """All-shots fused forward.  lam/mu/rho (nz, nx) and stf (S, nt),
    float32 and contiguous; src_z/src_x/rxz (S,) on the padded grid.
    Returns data (S, 4, n_rec, nt) float32 on the tensors' device.

    CPU tensors run `forward_plain`; CUDA tensors run the kernel."""
    global LAUNCHES
    src_z, src_x, rxz = _check_inputs(cfg, rs, lam, mu, rho, stf,
                                      src_z, src_x, rxz)
    if lam.device.type == "cpu":
        return forward_plain(cfg, rs, lam, mu, rho, stf, src_z, src_x, rxz)
    lib = _build.load()
    device = lam.device
    if device.type != "cuda":
        raise ValueError(f"forward_cuda takes CPU or CUDA tensors, got "
                         f"{device}")
    S = stf.shape[0]
    with torch.cuda.device(device):
        mat = material_fields(lam, mu, rho)
        mats = torch.stack(tuple(mat)).contiguous()          # (5, nz, nx)
        prof_z, prof_x = _profiles(cfg, device)
        src_z_d = src_z.to(device, torch.int32)
        src_x_d = src_x.to(device, torch.int32)
        rxz_d = rxz.to(device)
        state = torch.zeros((N_STATE_PLANES, S, cfg.nz, cfg.nx),
                            device=device, dtype=torch.float32)
        data = torch.zeros((S, 4, rs.n_rec, cfg.nt), device=device,
                           dtype=torch.float32)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.elastic_forward(
            mats.data_ptr(), prof_z.data_ptr(), prof_x.data_ptr(),
            stf.data_ptr(), src_z_d.data_ptr(), src_x_d.data_ptr(),
            rxz_d.data_ptr(), state.data_ptr(), data.data_ptr(),
            S, cfg.nz, cfg.nx, cfg.nt, rs.rec_row, rs.rec_x0, rs.n_rec,
            int(cfg.das_channel == "ezz"), ctypes.c_float(cfg.dt),
            ctypes.c_float(cfg.src_scale * cfg.dt), stream)
    if err != 0:
        msg = lib.elastic_error_string(err).decode()
        raise RuntimeError(f"elastic_forward kernel launch failed: {msg}")
    LAUNCHES += 3 * (cfg.nt - 1)
    return data
