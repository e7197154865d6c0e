"""Shot-batched losses and forwards on one device.

PyTorch counterpart of the single-device part of `sep2023_tpu/parallel.py`.
All shots of a chunk run together (the shot axis is a batch dimension of the
propagator and of the kernels); a long shot list runs in chunks whose
boundary strips fit device memory (`auto_shot_chunk`), with the chunked
gradient accumulator `_chunked_sum`.  Sharding shots over several cards is
ROADMAP M10.

Loss builders return
    loss(lam, mu, rho, stf, [geoms,] obs, weights)
with `weights` the per-shot misfit factors (ones by default).
"""
from __future__ import annotations

from typing import Sequence

import torch

from sep2023_tpu_torch import propagator
from sep2023_tpu_torch.config import SimConfig, Survey
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.ops import misfit as mf
from sep2023_tpu_torch.propagator import ShotGeom

# Strip budget when the device reports no memory size (the CPU).
FALLBACK_BUDGET_BYTES = 6 << 30


def survey_to_geoms(survey: Survey, npml: int, *, device,
                    dtype=torch.float32) -> ShotGeom:
    """Batched ShotGeom (leading shot axis) with the npml offset applied
    (Src_Rec.cu:87-116 does the same when parsing the survey JSON).  Ragged
    surveys carry their per-shot padded (S, R_max) spreads straight through
    (padding replicates real receivers; zero its weights via
    `survey.live_trace_weights()`)."""
    S = survey.n_shots
    idx = lambda a: torch.as_tensor(a + npml, dtype=torch.int64,
                                    device=device)
    return ShotGeom(
        src_z=idx(survey.src_z),
        src_x=idx(survey.src_x),
        rxz=torch.as_tensor(survey.src_rxz, dtype=dtype, device=device),
        rec_z=idx(survey.rec_z).expand(S, survey.n_rec),
        rec_x=idx(survey.rec_x).expand(S, survey.n_rec),
    )


def default_shot_misfit(channels: Sequence[str] = ("ett",)):
    """Per-shot L2 misfits (S,) of (S, 4, R, nt) data."""
    return lambda o, s: torch.stack([mf.l2_misfit(o[i], s[i], channels)
                                     for i in range(o.shape[0])])


def strip_bytes_per_shot(cfg: SimConfig, itemsize: int = 4) -> int:
    """Boundary-strip bytes one shot's gradient holds in device memory: the
    port's flat layout, (nt-1) steps x 5 fields x 2 L (nz + nx) values
    (129 MB a shot at the reference 165x265, nt=1501, in float32).
    itemsize: 8 for float64 runs."""
    return ((cfg.nt - 1) * propagator.N_FIELDS * propagator.strip_len(cfg)
            * itemsize)


def hbm_budget_bytes(device=None) -> int:
    """Boundary-strip budget for `auto_shot_chunk`: 3/8 of a CUDA device's
    memory (`torch.cuda.mem_get_info`; the other 5/8 cover the model and
    gradient planes, recordings and temporaries), or
    FALLBACK_BUDGET_BYTES for a device that reports none (the CPU)."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return FALLBACK_BUDGET_BYTES
    _, total = torch.cuda.mem_get_info(device)
    return max(1 << 30, (total * 3) // 8)


def auto_shot_chunk(cfg: SimConfig, n_shots: int, *,
                    budget_bytes: int | None = None, itemsize: int = 4,
                    device=None) -> int:
    """Shots in flight for gradient evaluations: the largest chunk whose
    strips fit the budget (`hbm_budget_bytes(device)` when budget_bytes is
    None), or 0 (unchunked) when every shot fits."""
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes(device)
    n_shots = max(1, n_shots)
    per_shot = strip_bytes_per_shot(cfg, itemsize)
    if per_shot * n_shots <= budget_bytes:
        return 0
    return max(1, min(n_shots, int(budget_bytes // per_shot)))


def _chunks(S: int, shot_chunk: int):
    """Contiguous shot ranges of shot_chunk shots; a ragged tail is one
    smaller last range (no replica padding)."""
    chunk = shot_chunk if shot_chunk and shot_chunk < S else S
    return [(a, min(a + chunk, S)) for a in range(0, S, chunk)]


class _ChunkedSum(torch.autograd.Function):
    """Sum of chunk losses whose forward also takes each chunk's (model,
    stf) gradients, so that only one chunk's boundary strips are alive at a
    time: forward, reconstruction and adjoint, 3 wavefield passes, not 4.
    The data (rest, weights) get zero gradients."""

    @staticmethod
    def forward(ctx, chunk_loss, ranges, n_model, n_rest, *flat):
        model = flat[:n_model]
        stf = flat[n_model]
        rest = flat[n_model + 1:n_model + 1 + n_rest]
        weights = flat[-1]
        total = torch.zeros((), dtype=stf.dtype, device=stf.device)
        g_model = [torch.zeros_like(m) for m in model]
        g_stf = torch.zeros_like(stf)
        for a, b in ranges:
            with torch.enable_grad():
                m = tuple(x.detach().requires_grad_() for x in model)
                s = stf[a:b].detach().requires_grad_()
                val = chunk_loss(m, s, tuple(r[a:b] for r in rest),
                                 weights[a:b])
                grads = torch.autograd.grad(val, (*m, s))
            total += val.detach()
            for g, d in zip(g_model, grads[:n_model]):
                g += d
            g_stf[a:b] = grads[n_model]
        ctx.save_for_backward(*g_model, g_stf)
        ctx.rest_like = [(r.shape, r.dtype, r.device) for r in rest]
        ctx.w_like = (weights.shape, weights.dtype, weights.device)
        return total

    @staticmethod
    def backward(ctx, ct):
        *g_model, g_stf = ctx.saved_tensors
        zero = lambda shape, dtype, device: (
            torch.zeros(shape, dtype=dtype, device=device)
            if dtype.is_floating_point else None)
        return (None, None, None, None, *(ct * g for g in g_model),
                ct * g_stf, *(zero(*r) for r in ctx.rest_like),
                zero(*ctx.w_like))


def _chunked_sum(chunk_loss, model, stf, rest, weights, shot_chunk: int):
    """Sum chunk_loss(model, stf_chunk, rest_chunk, w_chunk) over contiguous
    shot chunks (`sep2023_tpu/parallel.py::_chunked_sum`, the reference's
    chunk loop, Torch_Fwi.cpp:59-95).  model: tuple of tensors; stf,
    weights and every tensor of `rest` lead with the shot axis.

    With one chunk it is a plain, fully differentiable call.  With more,
    it is the gradient accumulator `_ChunkedSum`: gradients flow to
    `model` and `stf`, the set the reference's native op emits
    ({misfit, gLambda, gMu, gDen, gStf}, Torch_Fwi.cpp:102-103), and
    `rest` and `weights` get zeros (PARITY.md:79-87)."""
    S = weights.shape[0]
    ranges = _chunks(S, shot_chunk)
    if len(ranges) == 1:
        return chunk_loss(model, stf, rest, weights)
    return _ChunkedSum.apply(chunk_loss, ranges, len(model), len(rest),
                             *model, stf, *rest, weights)


def make_local_misfit(cfg: SimConfig, channels: Sequence[str] = ("ett",),
                      shot_chunk: int = 0):
    """The plain propagator's L2 loss:
    loss(lam, mu, rho, stf, geoms, obs, weights).  The adjoint source
    flows back into the propagator as the data cotangent."""
    fn = default_shot_misfit(channels)

    def loss(lam, mu, rho, stf, geoms, obs, weights):
        def chunk_loss(model, stf_c, rest_c, w_c):
            geoms_c, obs_c = ShotGeom(*rest_c[:5]), rest_c[5]
            syn = propagator.propagate_shots(cfg, *model, stf_c, geoms_c)
            return (w_c * fn(obs_c, syn)).sum()

        return _chunked_sum(chunk_loss, (lam, mu, rho), stf,
                            (*geoms[:5], obs), weights, shot_chunk)

    return loss


def _row_survey(cfg: SimConfig, survey: Survey) -> cuda_engine.RowSurvey:
    rs = (None if survey.ragged
          else cuda_engine.check_row_survey(survey.rec_z + cfg.npml,
                                            survey.rec_x + cfg.npml))
    if rs is None:
        raise NotImplementedError(
            "the CUDA kernels record one contiguous receiver row; ragged, "
            "multi-row and fiber surveys need FiberSurvey recording "
            "(ROADMAP K1-fiber), a receiver column the transposed plan "
            "(ROADMAP K1, transpose_plan)")
    return rs


def make_cuda_misfit(cfg: SimConfig, survey: Survey,
                     channels: Sequence[str] = ("ett",),
                     shot_chunk: int = 0):
    """The kernels' L2 loss for a row survey (`make_pallas_misfit`'s
    counterpart): loss(lam, mu, rho, stf, obs, weights), through
    cuda_engine.propagate_cuda: the CUDA kernels on CUDA tensors, their
    plain versions on CPU tensors.  Other surveys raise (ROADMAP
    K1-fiber)."""
    rs = _row_survey(cfg, survey)
    src_z = survey.src_z + cfg.npml
    src_x = survey.src_x + cfg.npml
    rxz = survey.src_rxz
    fn = default_shot_misfit(channels)

    def loss(lam, mu, rho, stf, obs, weights):
        def chunk_loss(model, stf_c, rest_c, w_c):
            (obs_c, shots) = rest_c
            idx = shots.cpu().numpy()
            syn = cuda_engine.propagate_cuda(cfg, rs, *model, stf_c,
                                             src_z[idx], src_x[idx],
                                             rxz[idx])
            return (w_c * fn(obs_c, syn)).sum()

        shots = torch.arange(stf.shape[0])
        return _chunked_sum(chunk_loss, (lam, mu, rho), stf, (obs, shots),
                            weights, shot_chunk)

    return loss


def make_forward(cfg: SimConfig, survey: Survey, *, use_kernels: bool,
                 shot_chunk: int = 0, device, dtype=torch.float32):
    """The forward for observed data (twin experiments), through the same
    engine as the loss: fwd(lam, mu, rho, stf) -> (S, 4, R, nt).  With
    use_kernels, cuda_engine.forward_cuda on a row survey; else the plain
    propagator.  Runs without autograd, in shot chunks."""
    S = survey.n_shots
    if use_kernels:
        rs = _row_survey(cfg, survey)
        src_z = survey.src_z + cfg.npml
        src_x = survey.src_x + cfg.npml
        rxz = survey.src_rxz
    else:
        geoms = survey_to_geoms(survey, cfg.npml, device=device, dtype=dtype)

    @torch.no_grad()
    def fwd(lam, mu, rho, stf):
        out = []
        for a, b in _chunks(S, shot_chunk):
            if use_kernels:
                out.append(cuda_engine.forward_cuda(
                    cfg, rs, lam, mu, rho, stf[a:b].contiguous(),
                    src_z[a:b], src_x[a:b], rxz[a:b]))
            else:
                g = ShotGeom(*(None if t is None else t[a:b]
                               for t in geoms))
                out.append(propagator.propagate_shots(cfg, lam, mu, rho,
                                                      stf[a:b], g))
        return torch.cat(out)

    return fwd
