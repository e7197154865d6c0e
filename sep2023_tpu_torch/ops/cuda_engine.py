"""Fused elastic engine on the GPU: the hand-written CUDA kernels
`csrc/elastic_fwd.cu` (forward, optionally saving the boundary strips) and
`csrc/elastic_bwd.cu` (the boundary-saving adjoint), and their plain
PyTorch versions.

Counterpart of `sep2023_tpu/ops/pallas_engine.py` for a row survey:
`forward_cuda` of `forward_pallas`/`_run_forward` (K1), `backward_cuda` of
`_run_backward` (K2), and `propagate_cuda`, a `torch.autograd.Function`, of
`propagate_pallas` with `_pp_fwd`/`_pp_bwd`.  Data is (S, 4, n_rec, nt)
float32.  The strips are (S, nt-1, 5, strip_len) in the flat layout of
`propagator._extract_strips`, the final fields (5, S, nz, nx) in Fields
order; kernels and plain versions share both.

The wrappers take their plain versions only for tensors that lie on the
CPU.  On CUDA tensors they launch the kernels or raise: they never drop to
the plain versions or to the CPU.  `LAUNCHES` and `LAUNCHES_BWD` count the
kernel launches (`LAUNCHES_STRIPS` the forward's with strip saving) and
`PLAIN_CALLS` the calls of each plain version, so a run
can show which path it went through.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from sep2023_tpu_torch import cpml as cpml_mod
from sep2023_tpu_torch import propagator
from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.medium import material_fields
from sep2023_tpu_torch.ops import _build
from sep2023_tpu_torch.propagator import Fields, ShotGeom

# Kernel launches made by forward_cuda: 3 per time step (stress, velocity,
# record), with or without strip saving.  Read and reset by callers that
# check the path they ran.
LAUNCHES = 0
# The part of LAUNCHES made with strip saving (the gradient's forward).
LAUNCHES_STRIPS = 0
# Kernel launches made by backward_cuda and reconstruct_cuda: 2 per time
# step (velocity, stress) and 1 shot sum.
LAUNCHES_BWD = 0
# Calls of each plain version (on CPU tensors, or by a caller comparing).
PLAIN_CALLS = {"forward_plain": 0, "forward_plain_strips": 0,
               "backward_plain": 0, "reconstruct_plain": 0}

N_STATE_PLANES = 13  # 5 fields + 8 CPML psi
N_WORK_PLANES = 21   # 5 adjoint fields + 8 adjoint psi + 8 stencil cotangents


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


def _check_tensor(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, lam on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _check_inputs(cfg: SimConfig, rs, lam, mu, rho, stf, src_z, src_x, rxz):
    """Validate everything the kernel would otherwise read out of bounds;
    returns (src_z, src_x, rxz) as host int64 / float tensors."""
    if not isinstance(rs, RowSurvey):
        raise NotImplementedError(
            f"the CUDA kernels take a RowSurvey; got {type(rs).__name__} "
            "(FiberSurvey recording is ROADMAP K1-fiber)")
    if cfg.das_channel not in ("exx", "ezz"):
        raise NotImplementedError(
            f"das_channel {cfg.das_channel!r} is not in the kernel yet "
            "(weighted fiber recording is ROADMAP K1-fiber)")
    device = lam.device
    for name, t in (("lam", lam), ("mu", mu), ("rho", rho)):
        _check_tensor(name, t, (cfg.nz, cfg.nx), device)
    _check_tensor("stf", stf, None, device)
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


def in_fused_range(cfg: SimConfig) -> bool:
    """Whether the JAX package takes the gradient of a row survey on this
    grid with its fused pair K1/K2, the pair the kernels here are held
    against: `pallas_engine.grad_vmem_fits` (its TPU memory model, full or
    compact backward) as plain numbers.  Past it the JAX package runs the
    streamed pair K3/K4 (165x265 and 465x640 are inside; 560x720 and
    814x2064 outside)."""
    pad = lambda n, m: -(-n // m) * m
    nz8, nx128 = pad(cfg.nz, 8), pad(cfg.nx, 128)
    plane = nz8 * nx128 * 4
    big = plane > 300_000
    staging = ((2 if big else 4) * (nz8 * 128 + 56 * nx128) * 4
               + 4 * (32 if big else 64) * nx128 * 4)
    return 28 * plane + staging < 36 << 20 or 24 * plane + staging < 39 << 20


def check_fused_range(cfg: SimConfig) -> None:
    """Raise for a gradient on the card past `in_fused_range`."""
    if not in_fused_range(cfg):
        raise NotImplementedError(
            f"a gradient on the {cfg.nz}x{cfg.nx} grid is the streamed "
            "pair's range in the JAX package, which the CUDA kernels have "
            "not been held against yet (ROADMAP K3/K4); device='cpu' runs "
            "the plain propagator")


def _check_residuals(cfg: SimConfig, rs, lam, stf, final, strips, d_data):
    """The backward's extra inputs: the forward's final fields and strips
    and the data cotangent, each float32, contiguous, on lam's device."""
    propagator.check_strip_grid(cfg)
    S = stf.shape[0]
    _check_tensor("final", final, (5, S, cfg.nz, cfg.nx), lam.device)
    _check_tensor("strips", strips, (S, cfg.nt - 1, 5,
                                     propagator.strip_len(cfg)), lam.device)
    _check_tensor("d_data", d_data, (S, 4, rs.n_rec, cfg.nt), lam.device)


def _row_geoms(cfg, rs: RowSurvey, S, src_z, src_x, rxz, device, dtype):
    """The row survey as the plain propagator's ShotGeom."""
    rec_x = torch.arange(rs.rec_x0, rs.rec_x0 + rs.n_rec, device=device)
    return ShotGeom(
        src_z=torch.as_tensor(src_z).to(device, torch.int64).reshape(S),
        src_x=torch.as_tensor(src_x).to(device, torch.int64).reshape(S),
        rxz=torch.as_tensor(rxz).to(device, dtype).reshape(S),
        rec_z=torch.full((S, rs.n_rec), rs.rec_row, device=device),
        rec_x=rec_x.expand(S, rs.n_rec))


def forward_plain(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                  src_z, src_x, rxz):
    """The plain PyTorch version of the forward kernel:
    propagator.propagate_shots on the row survey, on the tensors' own
    device."""
    PLAIN_CALLS["forward_plain"] += 1
    geoms = _row_geoms(cfg, rs, stf.shape[0], src_z, src_x, rxz, lam.device,
                       lam.dtype)
    return propagator.propagate_shots(cfg, lam, mu, rho, stf, geoms)


@torch.no_grad()
def forward_plain_strips(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                         src_z, src_x, rxz):
    """The plain version of the forward kernel with strip saving: (data,
    strips (S, nt-1, 5, strip_len), final fields (5, S, nz, nx))."""
    PLAIN_CALLS["forward_plain_strips"] += 1
    geoms = _row_geoms(cfg, rs, stf.shape[0], src_z, src_x, rxz, lam.device,
                       lam.dtype)
    data, final, strips = propagator._forward(cfg, lam, mu, rho, stf, geoms,
                                              save_bnd=True)
    return data, strips, torch.stack(tuple(final))


@torch.no_grad()
def backward_plain(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                   src_z, src_x, rxz, final, strips, d_data):
    """The plain version of the backward kernel, propagator.adjoint on the
    row survey: (d_lam, d_mu, d_rho, d_stf), the material gradients kept
    inside the interior and chained through material_fields."""
    PLAIN_CALLS["backward_plain"] += 1
    geoms = _row_geoms(cfg, rs, stf.shape[0], src_z, src_x, rxz, lam.device,
                       lam.dtype)
    gmat, d_stf, _ = propagator.adjoint(cfg, lam, mu, rho, stf, geoms,
                                        Fields(*final), strips, d_data)
    return (*propagator.material_grads(cfg, lam, mu, rho, gmat), d_stf)


@torch.no_grad()
def reconstruct_plain(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                      src_z, src_x, rxz, final, strips):
    """The plain reconstruction alone (propagator.reconstruct): the fields
    (5, S, nz, nx) rebuilt back to t=0 from the final fields and strips."""
    PLAIN_CALLS["reconstruct_plain"] += 1
    geoms = _row_geoms(cfg, rs, stf.shape[0], src_z, src_x, rxz, lam.device,
                       lam.dtype)
    f0 = propagator.reconstruct(cfg, lam, mu, rho, stf, geoms,
                                Fields(*final), strips)
    return torch.stack(tuple(f0))


@functools.lru_cache(maxsize=8)
def _profiles(cfg: SimConfig, device: torch.device):
    """(6, nz) and (6, nx) float32 CPML profile rows in cpml.CpmlScaled
    order (ik, a, b, ik_h, a_h, b_h), built in float64 and cast.  Built
    once per (cfg, device); the kernels only read them."""
    cp = cpml_mod.cpml_scaled(cfg.nz, cfg.nx, cfg.npml, cfg.dz, cfg.dx,
                              cfg.dt, cfg.f0, dtype=np.float32)
    pz = np.stack([p.reshape(-1) for p in cp[:6]])
    px = np.stack([p.reshape(-1) for p in cp[6:]])
    return (torch.from_numpy(pz).to(device), torch.from_numpy(px).to(device))


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


def forward_cuda(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                 src_z, src_x, rxz, save_strips: bool = False):
    """All-shots fused forward.  lam/mu/rho (nz, nx) and stf (S, nt),
    float32 and contiguous; src_z/src_x/rxz (S,) on the padded grid.
    Returns data (S, 4, n_rec, nt) float32 on the tensors' device; with
    save_strips, (data, strips (S, nt-1, 5, strip_len), final fields
    (5, S, nz, nx)).

    CPU tensors run the plain versions; CUDA tensors run the kernel."""
    global LAUNCHES, LAUNCHES_STRIPS
    src_z, src_x, rxz = _check_inputs(cfg, rs, lam, mu, rho, stf,
                                      src_z, src_x, rxz)
    if save_strips:
        propagator.check_strip_grid(cfg)
    if lam.device.type == "cpu":
        if save_strips:
            return forward_plain_strips(cfg, rs, lam, mu, rho, stf, src_z,
                                        src_x, rxz)
        return forward_plain(cfg, rs, lam, mu, rho, stf, src_z, src_x, rxz)
    device = lam.device
    lib = _load(device)
    S = stf.shape[0]
    with torch.cuda.device(device):
        mats = torch.stack(tuple(material_fields(lam, mu, rho))).contiguous()
        prof_z, prof_x = _profiles(cfg, device)
        src_z_d = src_z.to(device, torch.int32)
        src_x_d = src_x.to(device, torch.int32)
        rxz_d = rxz.to(device)
        state = torch.zeros((N_STATE_PLANES, S, cfg.nz, cfg.nx),
                            device=device, dtype=torch.float32)
        data = torch.zeros((S, 4, rs.n_rec, cfg.nt), device=device,
                           dtype=torch.float32)
        strips = (torch.empty((S, cfg.nt - 1, 5, propagator.strip_len(cfg)),
                              device=device, dtype=torch.float32)
                  if save_strips else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.elastic_forward(
            mats.data_ptr(), prof_z.data_ptr(), prof_x.data_ptr(),
            stf.data_ptr(), src_z_d.data_ptr(), src_x_d.data_ptr(),
            rxz_d.data_ptr(), state.data_ptr(), data.data_ptr(),
            None if strips is None else strips.data_ptr(),
            S, cfg.nz, cfg.nx, cfg.nt, rs.rec_row, rs.rec_x0, rs.n_rec,
            int(cfg.das_channel == "ezz"), cfg.npml, cfg.n_bnd_layers,
            ctypes.c_float(cfg.dt), ctypes.c_float(cfg.src_scale * cfg.dt),
            stream)
    _raise_on(lib, err, "elastic_forward")
    LAUNCHES += 3 * (cfg.nt - 1)
    if save_strips:
        LAUNCHES_STRIPS += 3 * (cfg.nt - 1)
        return data, strips, state[:5]
    return data


def _backward_kernel(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                     src_z, src_x, rxz, final, strips, d_data):
    """Launch elastic_backward on CUDA tensors: (gmat (5, nz, nx), d_stf
    (S, nt), fields reconstructed at t=0 (5, S, nz, nx))."""
    global LAUNCHES_BWD
    device = lam.device
    lib = _load(device)
    S = stf.shape[0]
    with torch.cuda.device(device):
        mats = torch.stack(tuple(material_fields(lam, mu, rho))).contiguous()
        prof_z, prof_x = _profiles(cfg, device)
        src_z_d = src_z.to(device, torch.int32)
        src_x_d = src_x.to(device, torch.int32)
        rxz_d = rxz.to(device)
        fields = final.clone()
        zeros = lambda *shape: torch.zeros(shape, device=device,
                                           dtype=torch.float32)
        work = zeros(N_WORK_PLANES, S, cfg.nz, cfg.nx)
        gshot = zeros(S, 5, cfg.nz, cfg.nx)
        gmat = torch.empty((5, cfg.nz, cfg.nx), device=device,
                           dtype=torch.float32)
        d_stf = zeros(S, cfg.nt)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.elastic_backward(
            mats.data_ptr(), prof_z.data_ptr(), prof_x.data_ptr(),
            stf.data_ptr(), src_z_d.data_ptr(), src_x_d.data_ptr(),
            rxz_d.data_ptr(), strips.data_ptr(), d_data.data_ptr(),
            fields.data_ptr(), work.data_ptr(), gshot.data_ptr(),
            gmat.data_ptr(), d_stf.data_ptr(),
            S, cfg.nz, cfg.nx, cfg.nt, rs.rec_row, rs.rec_x0, rs.n_rec,
            int(cfg.das_channel == "ezz"), cfg.npml, cfg.n_bnd_layers,
            ctypes.c_float(cfg.dt), ctypes.c_float(cfg.src_scale * cfg.dt),
            stream)
    _raise_on(lib, err, "elastic_backward")
    LAUNCHES_BWD += 2 * (cfg.nt - 1) + 1
    return gmat, d_stf, fields


def backward_cuda(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                  src_z, src_x, rxz, final, strips, d_data):
    """The boundary-saving adjoint of all shots.  final (5, S, nz, nx) and
    strips come from forward_cuda(save_strips=True); d_data (S, 4, n_rec,
    nt) is the data cotangent.  Returns (d_lam, d_mu, d_rho, d_stf): the
    kernel's material-field gradients kept inside the interior and chained
    through material_fields by autograd, as _run_backward does.

    CPU tensors run backward_plain; CUDA tensors run the kernel."""
    src_z, src_x, rxz = _check_inputs(cfg, rs, lam, mu, rho, stf,
                                      src_z, src_x, rxz)
    _check_residuals(cfg, rs, lam, stf, final, strips, d_data)
    if lam.device.type == "cpu":
        return backward_plain(cfg, rs, lam, mu, rho, stf, src_z, src_x, rxz,
                              final, strips, d_data)
    check_fused_range(cfg)
    gmat, d_stf, _ = _backward_kernel(cfg, rs, lam, mu, rho, stf, src_z,
                                      src_x, rxz, final, strips, d_data)
    gmat = propagator.MatFields(*gmat)
    return (*propagator.material_grads(cfg, lam, mu, rho, gmat), d_stf)


def reconstruct_cuda(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                     src_z, src_x, rxz, final, strips):
    """The backward kernel's reconstruction alone, driven with a zero data
    cotangent: the fields (5, S, nz, nx) rebuilt back to t=0.  CUDA
    tensors only; reconstruct_plain is its plain version."""
    src_z, src_x, rxz = _check_inputs(cfg, rs, lam, mu, rho, stf,
                                      src_z, src_x, rxz)
    d_data = torch.zeros((stf.shape[0], 4, rs.n_rec, cfg.nt),
                         device=lam.device, dtype=torch.float32)
    _check_residuals(cfg, rs, lam, stf, final, strips, d_data)
    return _backward_kernel(cfg, rs, lam, mu, rho, stf, src_z, src_x, rxz,
                            final, strips, d_data)[2]


class _PropagateCuda(torch.autograd.Function):
    """forward_cuda with strip saving, and backward_cuda as its backward:
    the counterpart of propagate_pallas's custom_vjp (_pp_fwd/_pp_bwd)."""

    @staticmethod
    def forward(ctx, cfg, rs, src_z, src_x, rxz, lam, mu, rho, stf):
        if not any(ctx.needs_input_grad[5:]):
            return forward_cuda(cfg, rs, lam, mu, rho, stf, src_z, src_x, rxz)
        data, strips, final = forward_cuda(cfg, rs, lam, mu, rho, stf,
                                           src_z, src_x, rxz,
                                           save_strips=True)
        ctx.args = (cfg, rs, src_z, src_x, rxz)
        ctx.save_for_backward(lam, mu, rho, stf, final, strips)
        return data

    @staticmethod
    def backward(ctx, d_data):
        cfg, rs, src_z, src_x, rxz = ctx.args
        lam, mu, rho, stf, final, strips = ctx.saved_tensors
        grads = backward_cuda(cfg, rs, lam, mu, rho, stf, src_z, src_x, rxz,
                              final, strips, d_data.contiguous())
        return (None,) * 5 + tuple(grads)


def propagate_cuda(cfg: SimConfig, rs: RowSurvey, lam, mu, rho, stf,
                   src_z, src_x, rxz):
    """Differentiable all-shots propagator: data (S, 4, n_rec, nt), with
    gradients of lam, mu, rho and stf by the boundary-saving adjoint.
    float32 row surveys only: CUDA tensors run the kernels, CPU tensors
    their plain versions; anything else raises, and so does a gradient on
    the card past `in_fused_range`."""
    if not isinstance(rs, RowSurvey):
        raise NotImplementedError(
            "the CUDA kernels record one contiguous receiver row; other "
            "surveys need FiberSurvey recording (ROADMAP K1-fiber)")
    if lam.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA kernels compute in float32, not {lam.dtype}; the "
            "plain propagator (propagator.propagate_shots) runs other "
            "dtypes on the CPU")
    if lam.device.type != "cpu" and torch.is_grad_enabled() and any(
            a.requires_grad for a in (lam, mu, rho, stf)):
        check_fused_range(cfg)
    return _PropagateCuda.apply(cfg, rs, src_z, src_x, rxz,
                                lam.contiguous(), mu.contiguous(),
                                rho.contiguous(), stf.contiguous())
