"""Shot-batched losses and forwards on one device.

PyTorch counterpart of the single-device part of `sep2023_tpu/parallel.py`.
All shots of a chunk run together (the shot axis is a batch dimension of the
propagator and of the kernels); a long shot list runs in chunks whose
boundary strips and state planes fit device memory (`auto_shot_chunk`),
with the chunked gradient accumulator `_chunked_sum`.  Surveys reach the
kernels through a plan (`_cuda_plan`): a receiver row, any other shared
spread as point receivers, and ragged spreads as the union of their points
with a per-shot gather.  Sharding shots over several cards is ROADMAP M10.

Loss builders return
    loss(lam, mu, rho, stf, [geoms,] obs, weights)
with `weights` the per-shot misfit factors (ones by default).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sep2023_tpu_torch import acoustic as acoustic_mod
from sep2023_tpu_torch import propagator
from sep2023_tpu_torch.config import SimConfig, Survey
from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine
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


def strip_bytes_per_shot(cfg: SimConfig, acoustic: bool = False,
                         itemsize: int = 4) -> int:
    """Boundary-strip bytes one shot's gradient holds in device memory: the
    port's flat layout, (nt-1) steps x 5 fields (3 acoustic ones) x
    2 L (nz + nx) values (129 MB a shot at the reference 165x265, nt=1501,
    in float32; 77 MB acoustic).  itemsize: 8 for float64 runs."""
    n_fields = acoustic_mod.AC_N_FIELDS if acoustic else propagator.N_FIELDS
    return (cfg.nt - 1) * n_fields * propagator.strip_len(cfg) * itemsize


def state_bytes_per_shot(cfg: SimConfig, acoustic: bool = False,
                         itemsize: int = 4) -> int:
    """Bytes one shot's gradient holds in device memory beside its strips,
    as the kernels' wrappers allocate them.  Elastic
    (`cuda_engine.state_floats_per_shot`): the forward's final fields, the
    backward's double buffer of the fields, its 15 work planes and 5
    per-shot gradients, 35 planes of nz x nx, and 6 planes of CPML memory of
    each axis in band storage (6.8 MB a shot at 165x265, 240 MB at
    814x2064, in float32).  Acoustic (`cuda_acoustic.state_floats_per_shot`):
    the forward's final fields, the backward's double buffer of the fields,
    its 9 work planes and 3 per-shot gradients, 21 planes, and 3 planes of
    CPML memory of each axis in band storage."""
    if acoustic:
        return cuda_acoustic.state_floats_per_shot(cfg) * itemsize
    return cuda_engine.state_floats_per_shot(cfg) * itemsize


def hbm_budget_bytes(device=None) -> int:
    """Budget of `auto_shot_chunk` for the strips and state planes of the
    shots in flight: 3/8 of a CUDA device's memory
    (`torch.cuda.mem_get_info`; the other 5/8 cover the model planes,
    recordings, cotangents and temporaries), or FALLBACK_BUDGET_BYTES for a
    device that reports none (the CPU)."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return FALLBACK_BUDGET_BYTES
    _, total = torch.cuda.mem_get_info(device)
    return max(1 << 30, (total * 3) // 8)


def auto_shot_chunk(cfg: SimConfig, n_shots: int, *, acoustic: bool = False,
                    budget_bytes: int | None = None, itemsize: int = 4,
                    device=None, n_devices: int = 1) -> int:
    """Shots in flight for gradient evaluations (acoustic: for the acoustic
    gradient and image): the largest chunk whose strips and state planes fit
    the budget (`hbm_budget_bytes(device)` when budget_bytes is None), or 0
    (unchunked) when every shot fits.  `n_shots` is the global shot count;
    with the shots split over `n_devices` devices the bound applies to each
    device's ceil(n_shots / n_devices) local shots, the JAX package's
    rule."""
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes(device)
    local_shots = -(-max(1, n_shots) // max(1, n_devices))
    per_shot = (strip_bytes_per_shot(cfg, acoustic, itemsize)
                + state_bytes_per_shot(cfg, acoustic, itemsize))
    if per_shot * local_shots <= budget_bytes:
        return 0
    return max(1, min(local_shots, int(budget_bytes // per_shot)))


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
    `rest` and `weights` get zeros (PARITY.md:79-87).  Data-side gradients
    (to the observed data, the per-trace aux or the weights) under
    chunking are therefore zeros; shot_chunk=0, one chunk, is the way to
    get them.  There is no checkpointed oracle as the JAX package's
    SEP2023_TPU_CHUNK_REMAT: no workflow here differentiates the data."""
    S = weights.shape[0]
    ranges = _chunks(S, shot_chunk)
    if len(ranges) == 1:
        return chunk_loss(model, stf, rest, weights)
    return _ChunkedSum.apply(chunk_loss, ranges, len(model), len(rest),
                             *model, stf, *rest, weights)


def make_local_misfit(cfg: SimConfig, channels: Sequence[str] = ("ett",),
                      shot_chunk: int = 0, misfit_fn=None):
    """The plain propagator's loss:
    loss(lam, mu, rho, stf, geoms, obs, weights, *trace_aux).

    misfit_fn(obs_s, syn_s, *aux_s) is a per-shot objective on (4, R, nt)
    data returning a scalar (default: L2 on `channels`), applied to the
    chunk through its batched form where it has one, else shot by shot
    (`_over_shots`); every tensor of trace_aux leads with the shot axis and
    is chunked with the other per-shot inputs.  The adjoint source flows
    back into the propagator as the data cotangent either way."""
    fn = (default_shot_misfit(channels) if misfit_fn is None
          else _over_shots(misfit_fn))

    def loss(lam, mu, rho, stf, geoms, obs, weights, *trace_aux):
        def chunk_loss(model, stf_c, rest_c, w_c):
            geoms_c, obs_c, aux_c = ShotGeom(*rest_c[:5]), rest_c[5], \
                rest_c[6:]
            syn = propagator.propagate_shots(cfg, *model, stf_c, geoms_c)
            return (w_c * fn(obs_c, syn, *aux_c)).sum()

        return _chunked_sum(chunk_loss, (lam, mu, rho), stf,
                            (*geoms[:5], obs, *trace_aux), weights,
                            shot_chunk)

    return loss


def _cuda_plan(cfg: SimConfig, survey: Survey, das_w=None):
    """(FastPlan, union indices) of the survey (`_pallas_plan`'s
    counterpart).  A shared spread plans as it is; a ragged survey plans
    the union of all its distinct receiver points, which the kernels record
    once per shot, and comes with the (S, R_max) indices with which each
    shot picks its own (padded) spread out of the union.  Raises ValueError
    for a survey no plan takes."""
    if survey.ragged:
        if das_w is not None:
            raise ValueError("ragged surveys with directional fiber weights "
                             "need the plain propagator")
        rz = survey.rec_z + cfg.npml
        rx = survey.rec_x + cfg.npml
        pairs = np.stack([rz.ravel(), rx.ravel()], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        plan = cuda_engine.plan_fast_path(cfg, uniq[:, 0], uniq[:, 1])
        if plan is None:
            raise ValueError("the ragged survey's union spread lies outside "
                             "the recordable range")
        return plan, torch.from_numpy(inv.reshape(rz.shape).astype(np.int64))
    plan = cuda_engine.plan_fast_path(cfg, survey.rec_z + cfg.npml,
                                      survey.rec_x + cfg.npml, das_w=das_w)
    if plan is None:
        raise ValueError("the survey's receivers lie outside the recordable "
                         "range")
    return plan, None


def _gather_union(syn, uidx_c):
    """(S, 4, R_union, nt) kernel output -> each shot's own (padded) spread
    through its (R_max,) union indices; autograd carries the cotangent
    back into the union."""
    return torch.take_along_dim(syn, uidx_c[:, None, :, None], dim=2)


def _over_shots(fn):
    """A per-shot misfit fn(obs_s, syn_s, *aux_s) -> scalar as a function of
    the whole chunk, (S,) (the JAX package's jax.vmap(fn)): fn.batched when
    the misfit has that form (`misfit.make_preprocessed_l2`), else a Python
    loop over the shot axis; autograd differentiates through either."""
    batched = getattr(fn, "batched", None)
    if batched is not None:
        return batched
    return lambda o, s, *aux: torch.stack(
        [fn(o[i], s[i], *(a[i] for a in aux)) for i in range(o.shape[0])])


def make_cuda_misfit(cfg: SimConfig, survey: Survey,
                     channels: Sequence[str] = ("ett",),
                     shot_chunk: int = 0, misfit_fn=None, das_w=None):
    """The kernels' loss (`make_pallas_misfit`'s counterpart):
    loss(lam, mu, rho, stf, obs, weights, *trace_aux), through
    cuda_engine.propagate_cuda_plan: the CUDA kernels on CUDA tensors, their
    plain versions on CPU tensors.

    The survey must fit a plan (`_cuda_plan`: a receiver row, point
    receivers, or a ragged union); das_w carries the (R, 3) fiber weights
    when cfg.das_channel is 'weighted'.  misfit_fn(obs_s, syn_s, *aux_s) is
    a per-shot objective on (4, R, nt) data returning a scalar (default: L2
    on `channels`); it is applied to the chunk through its batched form
    where it has one, else shot by shot (`_over_shots`), and the weighted
    results are summed.  Every tensor of trace_aux leads with the
    shot axis.  shot_chunk > 0 bounds the strip memory through the chunked
    accumulator (`_chunked_sum`; gradients flow to the model and stf)."""
    plan, uidx = _cuda_plan(cfg, survey, das_w)
    src_z = survey.src_z + cfg.npml
    src_x = survey.src_x + cfg.npml
    rxz = survey.src_rxz
    fn = (default_shot_misfit(channels) if misfit_fn is None
          else _over_shots(misfit_fn))

    def loss(lam, mu, rho, stf, obs, weights, *trace_aux):
        def chunk_loss(model, stf_c, rest_c, w_c):
            shots, obs_c, *aux_c = rest_c
            idx = shots.numpy()
            syn = cuda_engine.propagate_cuda_plan(
                plan, *model, stf_c, src_z[idx], src_x[idx], rxz[idx])
            if uidx is not None:
                syn = _gather_union(syn, uidx[shots].to(syn.device))
            return (w_c * fn(obs_c, syn, *aux_c)).sum()

        shots = torch.arange(stf.shape[0])
        return _chunked_sum(chunk_loss, (lam, mu, rho), stf,
                            (shots, obs, *trace_aux), weights, shot_chunk)

    return loss


def make_forward(cfg: SimConfig, survey: Survey, *, use_kernels: bool,
                 shot_chunk: int = 0, device, dtype=torch.float32,
                 das_w=None):
    """The forward for observed data (twin experiments), through the same
    engine as the loss: fwd(lam, mu, rho, stf) -> (S, 4, R, nt).  With
    use_kernels, cuda_engine.forward_cuda_plan on the survey's plan (ragged
    surveys come back on their padded (S, R_max) spreads); else the plain
    propagator.  Runs without autograd, in shot chunks."""
    S = survey.n_shots
    if use_kernels:
        plan, uidx = _cuda_plan(cfg, survey, das_w)
        src_z = survey.src_z + cfg.npml
        src_x = survey.src_x + cfg.npml
        rxz = survey.src_rxz
    else:
        geoms = survey_to_geoms(survey, cfg.npml, device=device, dtype=dtype)
        if das_w is not None:
            w = torch.as_tensor(np.asarray(das_w)).to(device, dtype)
            geoms = geoms._replace(das_w=w.expand(S, *w.shape))

    @torch.no_grad()
    def fwd(lam, mu, rho, stf):
        out = []
        for a, b in _chunks(S, shot_chunk):
            if use_kernels:
                syn = cuda_engine.forward_cuda_plan(
                    plan, lam, mu, rho, stf[a:b].contiguous(),
                    src_z[a:b], src_x[a:b], rxz[a:b])
                if uidx is not None:
                    syn = _gather_union(syn, uidx[a:b].to(syn.device))
                out.append(syn)
            else:
                g = ShotGeom(*(None if t is None else t[a:b]
                               for t in geoms))
                out.append(propagator.propagate_shots(cfg, lam, mu, rho,
                                                      stf[a:b], g))
        return torch.cat(out)

    return fwd
