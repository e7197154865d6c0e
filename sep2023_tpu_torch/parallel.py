"""Shot-batched losses and forwards, on one device or sharded over several.

PyTorch counterpart of `sep2023_tpu/parallel.py`.  All shots of a chunk run
together (the shot axis is a batch dimension of the propagator and of the
kernels); a long shot list runs in chunks whose boundary strips and state
planes fit device memory (`auto_shot_chunk`), with the chunked gradient
accumulator `_chunked_sum`.  Surveys reach the kernels through a plan
(`_cuda_plan`): a receiver row, any other shared spread as point receivers,
and ragged spreads as the union of their points with a per-shot gather.

Several devices share the shots as the reference's multi-GPU scheduler does
(`Torch_Fwi.cpp:71-101`: one process, a thread a GPU, a host-side gradient
sum).  A mesh is a tuple of torch.device, one entry a shard (`shot_mesh`;
entries may repeat, as (cpu,) * 8 or (cuda:0, cuda:0)); the sharded losses
and `make_forward(mesh=)` run each shard's contiguous block of shots in a
thread of its own on its device (`_on_mesh`), the model replicated to every
shard by `_Replicate`, whose backward sums the shards' gradients in shard
order.  The shot count must be a multiple of the mesh size (`pad_shots`,
`pad_survey`).  `make_dd_misfit` adds the shot x domain split of
`mesh_2d`: each shard row splits the grid's x axis into column blocks
that exchange 2 ghost columns every half step, and differentiates by the
boundary-saving adjoint on the blocks (`_DDPropagate`).

Loss builders return
    loss(lam, mu, rho, stf, [geoms,] obs, weights, *trace_aux)
with `weights` the per-shot misfit factors (ones by default).
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sep2023_tpu_torch import acoustic as acoustic_mod
from sep2023_tpu_torch import propagator, spans
from sep2023_tpu_torch.config import SimConfig, Survey
from sep2023_tpu_torch.medium import MatFields, material_fields
from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine
from sep2023_tpu_torch.ops import misfit as mf
from sep2023_tpu_torch.propagator import Fields, Psi, ShotGeom

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


def shot_mesh(n_devices: int | None = None, *, device,
              n_shots: int | None = None):
    """The shot mesh: a tuple of torch.device, one entry a shard, or None
    when it comes to one device (`sep2023_tpu/cli.py::_resolve_mesh` and
    `sep2023_tpu/api.py:106-107`): n = min(n_devices or count, count,
    n_shots).  On a CUDA `device` count is torch.cuda.device_count() and
    the mesh is cuda:0 .. cuda:n-1; on the CPU n_devices = k gives k CPU
    shards (the JAX tests' virtual CPU devices), and 0 or None one."""
    device = torch.device(device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device] * max(1, n_devices or 1)
    n = min(n_devices or len(devices), len(devices),
            n_shots if n_shots is not None else len(devices))
    return tuple(devices[:n]) if n > 1 else None


def _pad_rows(a, rem: int):
    """a with its last row (leading axis) repeated rem more times."""
    if a is None or rem == 0:
        return a
    return torch.cat([a, a[-1:].expand(rem, *a.shape[1:])])


def pad_shots(stf, geoms: ShotGeom, obs, weights, n_devices: int,
              trace_aux=()):
    """Pad the shot axis to a multiple of n_devices with replicas of the
    last shot of weight 0: (stf, geoms, obs, weights, trace_aux)."""
    rem = (-stf.shape[0]) % n_devices
    if rem == 0:
        return stf, geoms, obs, weights, tuple(trace_aux)
    w = torch.cat([weights, weights.new_zeros(rem)])
    return (_pad_rows(stf, rem),
            ShotGeom(*(_pad_rows(g, rem) for g in geoms)),
            _pad_rows(obs, rem), w,
            tuple(_pad_rows(a, rem) for a in trace_aux))


def pad_survey(survey: Survey, n_devices: int) -> Survey:
    """The survey with the last shot's source entries replicated as
    `pad_shots` replicates its arrays, so that the kernels' loss builders,
    which take each shot's source from the survey, see the padded shot
    count.  Ragged surveys replicate the last shot's receivers and live
    mask too."""
    rem = (-survey.n_shots) % n_devices
    if rem == 0:
        return survey
    rep = lambda a: np.concatenate([a, np.repeat(a[-1:], rem, axis=0)])
    ragged = survey.ragged
    return Survey(src_z=rep(survey.src_z), src_x=rep(survey.src_x),
                  rec_z=rep(survey.rec_z) if ragged else survey.rec_z,
                  rec_x=rep(survey.rec_x) if ragged else survey.rec_x,
                  src_rxz=rep(survey.src_rxz),
                  rec_live=(rep(survey.rec_live)
                            if survey.rec_live is not None else None))


def _on_mesh(mesh, fn):
    """[fn(i, dev) for each shard i of the mesh], each call in a thread of
    its own under its CUDA device, with the caller's grad mode; the results
    in shard order.  A shard's exception is raised here once every shard
    has ended."""
    grad = torch.is_grad_enabled()

    def run(i, dev):
        on_dev = (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext())
        with on_dev, torch.set_grad_enabled(grad):
            return fn(i, dev)

    with ThreadPoolExecutor(max_workers=len(mesh)) as pool:
        futures = [pool.submit(run, i, dev) for i, dev in enumerate(mesh)]
        return [f.result() for f in futures]


def _blocks(mesh, S: int):
    """The contiguous block of shots [a, b) of each shard (P('shot'))."""
    n = len(mesh)
    if S % n:
        raise ValueError(f"{S} shots do not split over a mesh of {n}: pad "
                         "them first (pad_shots, pad_survey)")
    return [(i * S // n, (i + 1) * S // n) for i in range(n)]


class _Replicate(torch.autograd.Function):
    """One copy of each tensor a shard, on the shard's device (the tensor
    itself where the devices agree).  The backward sums the shards'
    gradients on each tensor's own device in shard order: the gradient
    all-reduce of the reference's host-side sum (Torch_Fwi.cpp:96-101), in
    one order, so that two runs give the same bits."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.homes = [t.device for t in tensors]
        return tuple(t.to(dev) for dev in mesh for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        n = len(ctx.homes)
        out = []
        for k, home in enumerate(ctx.homes):
            total = None
            for g in grads[k::n]:
                if g is not None:
                    g = g.to(home)
                    total = g if total is None else total + g
            out.append(total)
        return (None, *out)


def _sharded_sum(mesh, shard_loss, model, per_shot):
    """sum over the shards of shard_loss(a, model_i, per_shot_i): a the
    global number of the shard's first shot, model_i the model's copy on
    its device, per_shot_i the shard's rows of every tensor of per_shot
    (leading shot axis) on its device, added on the first shard's device in
    shard order."""
    blocks = _blocks(mesh, per_shot[0].shape[0])
    copies = _Replicate.apply(mesh, *model)
    n = len(model)

    def run(i, dev):
        a, b = blocks[i]
        return shard_loss(a, copies[i * n:(i + 1) * n],
                          [t[a:b].to(dev) for t in per_shot])

    return _sum_in_order(_on_mesh(mesh, run))


def _sum_in_order(vals):
    """vals[0] + vals[1] + ... on the first value's device, in that order
    (one order, so that two runs give the same bits)."""
    total = vals[0]
    for v in vals[1:]:
        total = total + v.to(total.device)
    return total


def _check_aux(trace_aux, n_trace_aux: int):
    if len(trace_aux) != n_trace_aux:
        raise ValueError(f"the loss was built for {n_trace_aux} trace_aux "
                         f"tensors, got {len(trace_aux)}")


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


def _plan_in_range(cfg: SimConfig, survey: Survey, das_w=None):
    """(FastPlan, union indices) of the survey, or None when a receiver
    lies outside the range the kernels record (`cuda_engine.plan_fast_path`
    returns None).  A shared spread plans as it is; a ragged survey plans
    the union of all its distinct receiver points, which the kernels record
    once per shot, and comes with the (S, R_max) indices with which each
    shot picks its own (padded) spread out of the union.  A survey in range
    that the kernels reject (`cuda_engine._check_survey`) raises."""
    if survey.ragged:
        rz = survey.rec_z + cfg.npml
        rx = survey.rec_x + cfg.npml
        pairs = np.stack([rz.ravel(), rx.ravel()], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        plan = cuda_engine.plan_fast_path(cfg, uniq[:, 0], uniq[:, 1])
        return None if plan is None else (plan, torch.from_numpy(
            inv.reshape(rz.shape).astype(np.int64)))
    plan = cuda_engine.plan_fast_path(cfg, survey.rec_z + cfg.npml,
                                      survey.rec_x + cfg.npml, das_w=das_w)
    return None if plan is None else (plan, None)


def _cuda_plan(cfg: SimConfig, survey: Survey, das_w=None):
    """(FastPlan, union indices) of the survey (`_pallas_plan`'s
    counterpart, `_plan_in_range`).  Raises ValueError for a survey no plan
    takes."""
    if survey.ragged and das_w is not None:
        raise ValueError("ragged surveys with directional fiber weights "
                         "need the plain propagator")
    found = _plan_in_range(cfg, survey, das_w)
    if found is None:
        raise ValueError(("the ragged survey's union spread lies"
                          if survey.ragged else "the survey's receivers lie")
                         + " outside the recordable range")
    return found


def try_plan(cfg: SimConfig, survey: Survey):
    """The survey's FastPlan, or None when a receiver lies outside the
    range the kernels record: what the engine choice of the CLI and the api
    is made from.  A survey the kernels reject for another reason (a
    das_channel they do not take, 'weighted' without weights) raises here,
    before anything runs."""
    found = _plan_in_range(cfg, survey)
    return None if found is None else found[0]


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
    accumulator (`_chunked_sum`; gradients flow to the model and stf).
    first_shot: the survey's number of stf's first row (a shard of
    `make_cuda_sharded_misfit` passes its block's), so that each row fires
    its own shot's source and picks its own spread."""
    plan, uidx = _cuda_plan(cfg, survey, das_w)
    src_z = survey.src_z + cfg.npml
    src_x = survey.src_x + cfg.npml
    rxz = survey.src_rxz
    fn = (default_shot_misfit(channels) if misfit_fn is None
          else _over_shots(misfit_fn))

    def loss(lam, mu, rho, stf, obs, weights, *trace_aux, first_shot=0):
        def chunk_loss(model, stf_c, rest_c, w_c):
            shots, obs_c, *aux_c = rest_c
            with spans.span("parallel.chunk"):
                idx = shots.numpy()
                syn = cuda_engine.propagate_cuda_plan(
                    plan, *model, stf_c, src_z[idx], src_x[idx], rxz[idx])
                if uidx is not None:
                    syn = _gather_union(syn, spans.h2d(
                        uidx[shots].to(syn.device)))
                return (w_c * fn(obs_c, syn, *aux_c)).sum()

        shots = torch.arange(first_shot, first_shot + stf.shape[0])
        if shots[-1] >= survey.n_shots:
            raise ValueError(f"shots {first_shot}..{int(shots[-1])} of a "
                             f"survey of {survey.n_shots}")
        return _chunked_sum(chunk_loss, (lam, mu, rho), stf,
                            (shots, obs, *trace_aux), weights, shot_chunk)

    return loss


def make_sharded_misfit(cfg: SimConfig, mesh,
                        channels: Sequence[str] = ("ett",), misfit_fn=None,
                        n_trace_aux: int = 0, shot_chunk: int = 0):
    """The plain propagator's loss with the shots sharded over `mesh`
    (`sep2023_tpu/parallel.py::make_sharded_misfit`):
    loss(lam, mu, rho, stf, geoms, obs, weights, *trace_aux), each shard
    running `make_local_misfit` (with shot_chunk inside it) on its block
    of shots in a thread of its own.  Differentiable: the model's
    gradients are the sum of the shards'.  The shot count must be a
    multiple of the mesh size (`pad_shots`)."""
    local = make_local_misfit(cfg, channels=channels, shot_chunk=shot_chunk,
                              misfit_fn=misfit_fn)

    def loss(lam, mu, rho, stf, geoms, obs, weights, *trace_aux):
        _check_aux(trace_aux, n_trace_aux)
        geo = [g for g in geoms if g is not None]
        das = geoms.das_w is not None

        def shard(a, model, rows):
            stf_, obs_, w_, *rest = rows
            g = ShotGeom(*rest[:5], das_w=rest[5] if das else None)
            return local(*model, stf_, g, obs_, w_, *rest[len(geo):])

        return _sharded_sum(mesh, shard, (lam, mu, rho),
                            (stf, obs, weights, *geo, *trace_aux))

    return loss


def make_cuda_sharded_misfit(cfg: SimConfig, survey: Survey, mesh,
                             channels: Sequence[str] = ("ett",),
                             misfit_fn=None, n_trace_aux: int = 0,
                             shot_chunk: int = 0, das_w=None):
    """The kernels' loss with the shots sharded over `mesh`
    (`make_pallas_sharded_misfit`'s counterpart):
    loss(lam, mu, rho, stf, obs, weights, *trace_aux).  One plan for the
    (padded) survey; each shard runs `make_cuda_misfit`'s loss on its
    block of shots, numbered as in the survey, in a thread of its own on
    its device: a forward with strips and a backward a chunk.  The shot
    count must be the survey's and a multiple of the mesh size
    (`pad_shots`, `pad_survey`)."""
    local = make_cuda_misfit(cfg, survey, channels=channels,
                             shot_chunk=shot_chunk, misfit_fn=misfit_fn,
                             das_w=das_w)

    def loss(lam, mu, rho, stf, obs, weights, *trace_aux):
        _check_aux(trace_aux, n_trace_aux)
        if stf.shape[0] != survey.n_shots:
            raise ValueError(f"{stf.shape[0]} shots for a survey of "
                             f"{survey.n_shots}: pad_survey pads it")

        def shard(a, model, rows):
            return local(*model, *rows, first_shot=a)

        return _sharded_sum(mesh, shard, (lam, mu, rho),
                            (stf, obs, weights, *trace_aux))

    return loss


def make_forward(cfg: SimConfig, survey: Survey, *, use_kernels: bool,
                 mesh=None, shot_chunk: int = 0, device, dtype=torch.float32,
                 das_w=None):
    """The forward for observed data (twin experiments), through the same
    engine, mesh and chunks as the loss: fwd(lam, mu, rho, stf) -> (S, 4,
    R, nt).  With use_kernels, cuda_engine.forward_cuda_plan on the
    survey's plan (ragged surveys come back on their padded (S, R_max)
    spreads); else the plain propagator.  With a mesh the shots are padded
    to a multiple of its size, each shard runs its block in a thread of its
    own on its device, and the blocks are joined in shard order on the
    first shard's device without the padding.  Runs without autograd, in
    shot chunks (of each shard's block)."""
    S = survey.n_shots
    n_dev = 1 if mesh is None else len(mesh)
    survey = pad_survey(survey, n_dev)
    if use_kernels:
        plan, uidx = _cuda_plan(cfg, survey, das_w)
        src_z = survey.src_z + cfg.npml
        src_x = survey.src_x + cfg.npml
        rxz = survey.src_rxz
    else:
        geoms = survey_to_geoms(survey, cfg.npml, device=device, dtype=dtype)
        if das_w is not None:
            w = torch.as_tensor(np.asarray(das_w)).to(device, dtype)
            geoms = geoms._replace(das_w=w.expand(survey.n_shots, *w.shape))

    def block(lam, mu, rho, stf, first):
        """The data of shots first .. first + len(stf) of the survey."""
        out = []
        for a, b in _chunks(stf.shape[0], shot_chunk):
            g0, g1 = first + a, first + b
            if use_kernels:
                syn = cuda_engine.forward_cuda_plan(
                    plan, lam, mu, rho, stf[a:b].contiguous(),
                    src_z[g0:g1], src_x[g0:g1], rxz[g0:g1])
                if uidx is not None:
                    syn = _gather_union(syn, uidx[g0:g1].to(syn.device))
                out.append(syn)
            else:
                g = ShotGeom(*(None if t is None else t[g0:g1].to(lam.device)
                               for t in geoms))
                out.append(propagator.propagate_shots(cfg, lam, mu, rho,
                                                      stf[a:b], g))
        return torch.cat(out)

    @torch.no_grad()
    def fwd(lam, mu, rho, stf):
        if mesh is None:
            return block(lam, mu, rho, stf, 0)
        stf = _pad_rows(stf, survey.n_shots - S)
        blocks = _blocks(mesh, survey.n_shots)
        out = _on_mesh(mesh, lambda i, dev: block(
            lam.to(dev), mu.to(dev), rho.to(dev),
            stf[blocks[i][0]:blocks[i][1]].to(dev), blocks[i][0]))
        return torch.cat([o.to(mesh[0]) for o in out])[:S]

    return fwd


def mesh_2d(n_shot: int, n_x: int, devices=None):
    """A shot x domain mesh: n_shot rows of n_x devices (a tuple of
    tuples), taken in order from `devices` (default: every CUDA device);
    entries may repeat.  Shots split over the rows and the grid's x axis
    over each row's devices (`make_dd_misfit`)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_shot * n_x:
        raise ValueError(f"a {n_shot} x {n_x} mesh needs {n_shot * n_x} "
                         f"devices, got {len(devices)}")
    return tuple(tuple(devices[i * n_x:(i + 1) * n_x])
                 for i in range(n_shot))


# Ghost columns a block keeps on each side: the O(4) stencils' reach.
HALO = 2


def _x_blocks(nx: int, n_x: int):
    """The owned columns [x0, x1) of each of n_x contiguous blocks."""
    edges = [j * nx // n_x for j in range(n_x + 1)]
    if min(b - a for a, b in zip(edges, edges[1:])) < 2 * HALO:
        raise ValueError(f"{nx} columns do not split into {n_x} blocks of "
                         f"at least {2 * HALO}")
    return list(zip(edges, edges[1:]))


def _cols(a, x0: int, x1: int):
    """Columns [x0 - HALO, x1 + HALO) of a (..., nx), zeros past its
    edges."""
    lo, hi = max(x0 - HALO, 0), min(x1 + HALO, a.shape[-1])
    return F.pad(a[..., lo:hi], (lo - x0 + HALO, x1 + HALO - hi))


def _ghosted(owned):
    """Each block's owned columns (S, nz, w) with HALO ghost columns a side
    taken from its neighbours' owned edge columns (zeros at the grid's
    edges, as the stencils' zero padding), on its own device.  Under
    autograd its transpose adds a ghost's cotangent to the column that owns
    it."""
    out = []
    for j, a in enumerate(owned):
        zero = a.new_zeros(*a.shape[:-1], HALO)
        left = owned[j - 1][..., -HALO:].to(a.device) if j else zero
        right = (owned[j + 1][..., :HALO].to(a.device)
                 if j + 1 < len(owned) else zero)
        out.append(torch.cat([left, a, right], dim=-1))
    return out


def _exchange(blocks):
    """Each block's (S, nz, w + 2 HALO) field with its ghost columns
    refreshed from its neighbours' owned columns."""
    return _ghosted([a[..., HALO:-HALO] for a in blocks])


def _ghosted_fields(owned):
    """`_ghosted` of every field: a Fields of owned columns a block in, a
    Fields with ghost columns a block out."""
    return [Fields(*f) for f in zip(*(_ghosted(list(a))
                                      for a in zip(*owned)))]


class _Block(NamedTuple):
    """One column block of a mesh row: it owns columns [x0, x1) of the grid
    on device `dev` and holds the whole grid's material fields, CPML
    profiles and update masks on those columns and HALO ghost columns a
    side (zeros past the grid's edges)."""

    dev: torch.device
    x0: int
    x1: int
    mat: MatFields
    cp: tuple
    mask_f: tuple
    mask_i: tuple
    geom: ShotGeom      # source and receiver columns in the block's frame
    own_src: torch.Tensor   # (S,) 1 where the block owns the source column
    own_rec: torch.Tensor   # (S, 1, R) 1 where it owns the receiver column
    strip_cells: torch.Tensor   # its strip cells (`_strip_cells`)


def _dd_blocks(cfg: SimConfig, row, lam, mu, rho, geom: ShotGeom):
    """The column blocks of a mesh row, block j on row[j]: the material
    fields, CPML profiles and masks computed on the whole grid on lam's
    device and sliced; the source goes to the block that owns its column
    (the others fire a zero sample at their first owned column), and each
    block records the receivers in its columns."""
    dtype = lam.dtype
    mat = material_fields(lam, mu, rho)
    cp, mask_f = propagator._consts(cfg, device=lam.device, dtype=dtype)
    mask_i = propagator._interior_mask(cfg, device=lam.device, dtype=dtype)
    L, z0, z1, xl, xr = propagator._strip_bounds(cfg)
    z = np.arange(cfg.nz)[:, None]
    strip_rows = ((z >= z0) & (z < z0 + L)) | ((z >= z1) & (z < z1 + L))
    blocks = []
    for (x0, x1), dev in zip(_x_blocks(cfg.nx, len(row)), row):
        w = x1 - x0 + 2 * HALO
        col = lambda a: _cols(a, x0, x1).to(dev)
        own_src = (geom.src_x >= x0) & (geom.src_x < x1)
        rx = geom.rec_x.to(dev)
        blocks.append(_Block(
            dev=dev, x0=x0, x1=x1,
            mat=MatFields(*(col(m) for m in mat)),
            cp=cp._replace(**{k: col(getattr(cp, k)).contiguous()
                              for k in ("ikx", "ax", "bx", "ikx_h", "ax_h",
                                        "bx_h")}, **{
                k: getattr(cp, k).to(dev)
                for k in ("ikz", "az", "bz", "ikz_h", "az_h", "bz_h")}),
            mask_f=(mask_f[0].to(dev), col(mask_f[1])),
            mask_i=(mask_i[0].to(dev), col(mask_i[1])),
            geom=ShotGeom(
                src_z=geom.src_z.to(dev),
                src_x=torch.where(own_src, geom.src_x - x0 + HALO,
                                  HALO).to(dev),
                rxz=geom.rxz.to(dev), rec_z=geom.rec_z.to(dev),
                rec_x=(rx - x0 + HALO).clamp(1, w - 2),
                das_w=None if geom.das_w is None else geom.das_w.to(dev)),
            own_src=own_src.to(dev, dtype),
            own_rec=((rx >= x0) & (rx < x1)).to(dtype)[:, None],
            strip_cells=_strip_cells(strip_rows, x0, x1, xl, xr, L, dev)))
    return blocks


def _strip_cells(strip_rows, x0: int, x1: int, xl: int, xr: int, L: int,
                 dev):
    """The cells of the four 5-deep strips (`propagator._strip_bounds`) in
    owned columns [x0, x1), as flat indices into the block's
    (nz, x1 - x0 + 2 HALO) plane in row-major order, each cell once.  A
    side strip's columns are found by global column, so a block edge may
    cut a strip; the blocks' cells together are the grid's strip cells."""
    x = np.arange(x0, x1)[None, :]
    side = ((x >= xl) & (x < xl + L)) | ((x >= xr) & (x < xr + L))
    zz, xx = np.nonzero(strip_rows | side)
    cells = zz * (x1 - x0 + 2 * HALO) + xx + HALO
    return torch.as_tensor(cells, dtype=torch.int64, device=dev)


def _inject_block_strips(b: _Block, a, s):
    """The block's (S, nz, w + 2 HALO) field a with its strip cells
    overwritten by s (S, n)."""
    return a.reshape(a.shape[0], -1).index_copy(1, b.strip_cells, s
                                                 ).reshape(a.shape)


def _dd_step(cfg: SimConfig, blocks, states, amp):
    """One step of `propagator.elastic_step` on the blocks, each on its own
    columns and ghosts: the stress ghosts are refreshed after the stress
    update and the source (before the velocity update reads them), the
    velocity ghosts after the velocity update (before the next stress
    update and the recording read them).  states: a block's State with
    ghosts; amp (S,) the step's source sample on the first block's device.
    Returns (the blocks' next States, the record (S, 4, R) on the first
    block's device)."""
    stress, psi = [], []
    for b, (f, p) in zip(blocks, states):
        (szz, sxx, sxz), p1 = propagator._stress_update(f, p, b.mat, b.cp,
                                                        b.mask_f, cfg)
        szz, sxx = propagator._add_source(szz, sxx,
                                          amp.to(b.dev) * b.own_src, b.geom,
                                          cfg)
        stress.append((szz, sxx, sxz))
        psi.append(Psi(*p1, *p[4:]))
    stress = list(zip(*(_exchange(list(s)) for s in zip(*stress))))
    vel = []
    for j, (b, (f, _), s) in enumerate(zip(blocks, states, stress)):
        (vz, vx), p2 = propagator._velocity_update(
            Fields(f.vz, f.vx, *s), psi[j], b.mat, b.cp, b.mask_f, cfg)
        vel.append((vz, vx))
        psi[j] = Psi(*psi[j][:4], *p2)
    vel = list(zip(*(_exchange(list(v)) for v in zip(*vel))))
    out, rec = [], None
    for b, s, v, p in zip(blocks, stress, vel, psi):
        f3 = Fields(*v, *s)
        out.append(propagator.State(f3, p))
        r = (propagator._record(f3, b.geom, cfg) * b.own_rec).to(
            blocks[0].dev)
        rec = r if rec is None else rec + r
    return out, rec


def _dd_forward(cfg: SimConfig, blocks, stf, save_strips: bool = False):
    """The forward of a mesh row's shots on its blocks: data (S, 4, R, nt)
    on the first block's device, sample 0 zero.  With save_strips also
    each block's final fields on its owned columns (a Fields a block) and
    its strips (S, nt-1, 5, n) on its device, the values of its n strip
    cells (`_Block.strip_cells`) before step it."""
    S = stf.shape[0]
    dtype = stf.dtype
    states = [propagator.zero_state((S, cfg.nz, b.x1 - b.x0 + 2 * HALO),
                                    device=b.dev, dtype=dtype)
              for b in blocks]
    R = blocks[0].geom.rec_z.shape[1]
    data = torch.zeros((S, propagator.N_CHANNELS, R, cfg.nt),
                       device=blocks[0].dev, dtype=dtype)
    if save_strips:
        propagator.check_strip_grid(cfg)
        strips = [torch.empty((S, cfg.nt - 1, propagator.N_FIELDS,
                               len(b.strip_cells)), device=b.dev, dtype=dtype)
                  for b in blocks]
    for it in range(cfg.nt - 1):
        if save_strips:
            for b, st, s in zip(blocks, states, strips):
                s[:, it] = torch.stack(st.f, dim=1).reshape(
                    S, propagator.N_FIELDS, -1)[..., b.strip_cells]
        states, data[..., it + 1] = _dd_step(cfg, blocks, states, stf[:, it])
    if not save_strips:
        return data
    final = [Fields(*(a[..., HALO:-HALO].contiguous() for a in st.f))
             for st in states]
    return data, final, strips


def _dd_reverse_step(cfg: SimConfig, blocks, fields, bnd, amp):
    """`propagator._reverse_step` on the blocks: velocity reverse, the vz
    and vx strips injected, the source subtracted by the block that owns
    its column, the velocity ghosts refreshed; stress reverse, the stress
    strips injected, the stress ghosts refreshed.  fields: a block's
    Fields with fresh ghosts; bnd: a block's (S, 5, n) strips of the
    step."""
    out = []
    for b, f, s in zip(blocks, fields, bnd):
        f = propagator._velocity_reverse(f, b.mat, b.mask_i, cfg)
        szz, sxx = propagator._add_source(f.szz, f.sxx,
                                          amp.to(b.dev) * b.own_src, b.geom,
                                          cfg, sign=-1.0)
        out.append(Fields(_inject_block_strips(b, f.vz, s[:, 0]),
                          _inject_block_strips(b, f.vx, s[:, 1]),
                          szz, sxx, f.sxz))
    vz, vx = _exchange([f.vz for f in out]), _exchange([f.vx for f in out])
    stress = []
    for j, (b, f, s) in enumerate(zip(blocks, out, bnd)):
        f = propagator._stress_reverse(f._replace(vz=vz[j], vx=vx[j]), b.mat,
                                       b.mask_i, cfg)
        stress.append([_inject_block_strips(b, a, s[:, k])
                       for k, a in ((2, f.szz), (3, f.sxx), (4, f.sxz))])
    szz, sxx, sxz = (_exchange(list(a)) for a in zip(*stress))
    return [Fields(*a) for a in zip(vz, vx, szz, sxx, sxz)]


def _dd_reconstruct(cfg: SimConfig, blocks, stf, final, strips):
    """The blocks' fields (with ghosts) rebuilt back to t=0 from their final
    fields and strips: the primal half of `_dd_adjoint`, the blocked
    `propagator.reconstruct`."""
    f = _ghosted_fields(final)
    for it in reversed(range(cfg.nt - 1)):
        f = _dd_reverse_step(cfg, blocks, f, [s[:, it] for s in strips],
                             stf[:, it])
    return f


def _dd_adjoint(cfg: SimConfig, blocks, stf, final, strips, d_data):
    """`propagator.adjoint` on the blocks: each step reconstructs the
    blocks' state one step back (`_dd_reverse_step`) and takes autograd of
    one blocked step (`_dd_step`) there with zero CPML memory, as a
    function of the blocks' owned columns, so that the ghost refreshes'
    transpose adds a ghost's cotangent to its owner.  Returns (the
    material fields' gradients on the whole grid, on the first block's
    device, not yet masked; d_stf (S, nt))."""
    f = _ghosted_fields(final)
    owned = lambda a: a[..., HALO:-HALO]
    n_psi = len(Psi._fields)
    k = propagator.N_FIELDS + n_psi    # a block's state tensors
    zero = [torch.zeros_like(fj.vz) for fj in final]
    zero_psi = [torch.zeros_like(fj.vz) for fj in f]   # with ghosts
    adj = [[z] * k for z in zero]
    gmat = [[torch.zeros_like(owned(m)) for m in b.mat] for b in blocks]
    d_stf = torch.zeros_like(stf)
    for it in reversed(range(cfg.nt - 1)):
        amp = stf[:, it]
        f = _dd_reverse_step(cfg, blocks, f, [s[:, it] for s in strips], amp)
        with torch.enable_grad():
            own_f = [[owned(a).detach().requires_grad_() for a in fj]
                     for fj in f]
            psi = [[z.detach().requires_grad_() for _ in range(n_psi)]
                   for z in zero_psi]
            mats = [[m.detach().requires_grad_() for m in b.mat]
                    for b in blocks]
            amp_in = amp.detach().requires_grad_()
            states = [propagator.State(g, Psi(*pj))
                      for g, pj in zip(_ghosted_fields(own_f), psi)]
            out, rec = _dd_step(cfg, [b._replace(mat=MatFields(*m))
                                      for b, m in zip(blocks, mats)],
                                states, amp_in)
            outs = [owned(a) for st in out for a in (*st.f, *st.psi)]
            ins = [a for fj, pj in zip(own_f, psi) for a in (*fj, *pj)]
            grads = torch.autograd.grad(
                (*outs, rec), (*ins, *(m for mj in mats for m in mj), amp_in),
                (*(a for aj in adj for a in aj), d_data[..., it + 1]))
        n = len(blocks) * k
        # a ghost's CPML memory reaches no owned output: its cotangent is 0
        nf = propagator.N_FIELDS
        adj = [[*grads[j:j + nf], *map(owned, grads[j + nf:j + k])]
               for j in range(0, n, k)]
        for j, g in enumerate(gmat):
            for m, d in zip(g, grads[n + 5 * j:n + 5 * (j + 1)]):
                m += owned(d)
        d_stf[:, it] = grads[-1]
    home = blocks[0].dev
    gmat = MatFields(*(torch.cat([g[k].to(home) for g in gmat], dim=-1)
                       for k in range(5)))
    return gmat, d_stf


class _DDPropagate(torch.autograd.Function):
    """The forward of a mesh row's shots on its column blocks, and the
    boundary-saving adjoint on the same blocks as its backward: the
    blocked counterpart of `propagator._Propagate`.  It saves each block's
    strips and final fields on the block's device, not a graph a step."""

    @staticmethod
    def forward(ctx, cfg, row, geom, lam, mu, rho, stf):
        cuda_engine.count_plain("propagate_dd")
        blocks = _dd_blocks(cfg, row, lam, mu, rho, geom)
        if not any(ctx.needs_input_grad[3:]):
            return _dd_forward(cfg, blocks, stf)
        data, final, strips = _dd_forward(cfg, blocks, stf, save_strips=True)
        ctx.cfg, ctx.row, ctx.geom = cfg, row, geom
        ctx.save_for_backward(lam, mu, rho, stf,
                              *(a for f in final for a in f), *strips)
        return data

    @staticmethod
    def backward(ctx, d_data):
        lam, mu, rho, stf, *rest = ctx.saved_tensors
        n = len(ctx.row)
        nf = propagator.N_FIELDS
        final = [Fields(*rest[nf * j:nf * (j + 1)]) for j in range(n)]
        blocks = _dd_blocks(ctx.cfg, ctx.row, lam, mu, rho, ctx.geom)
        gmat, d_stf = _dd_adjoint(ctx.cfg, blocks, stf, final,
                                  rest[nf * n:], d_data)
        return (None, None, None,
                *propagator.material_grads(ctx.cfg, lam, mu, rho, gmat),
                d_stf)


def make_dd_misfit(cfg: SimConfig, mesh, channels: Sequence[str] = ("ett",)):
    """The shot x domain loss on a `mesh_2d` mesh
    (`sep2023_tpu/parallel.py::make_dd_misfit`):
    loss(lam, mu, rho, stf, geoms, obs, weights).  The shots split over
    the mesh rows, each row in a thread of its own with its copy of the
    model on its first device (`_Replicate`: the rows' gradients summed in
    row order); within a row the grid's x axis splits into contiguous
    column blocks, one a device, which exchange HALO ghost columns by hand
    every half step (the JAX package lets GSPMD insert them).  The
    material fields, the CPML profiles and the masks are computed on the
    whole grid and sliced.  The gradient is the boundary-saving adjoint on
    the blocks (`_DDPropagate`), as the JAX package's, whose `dd` path
    differentiates its XLA engine's custom_vjp: loss and gradients equal
    `make_local_misfit`'s on the whole grid, and each block keeps its
    strips and final fields.  The plain step runs on whatever device the
    mesh names, on the card too; each row's call counts one
    `cuda_engine.PLAIN_CALLS["propagate_dd"]`.  The shot count must be a
    multiple of the row count."""
    rows = [tuple(torch.device(d) for d in r) for r in mesh]
    heads = tuple(r[0] for r in rows)
    fn = default_shot_misfit(channels)

    def loss(lam, mu, rho, stf, geoms, obs, weights):
        blocks = _blocks(heads, stf.shape[0])
        copies = _Replicate.apply(heads, lam, mu, rho)

        def run(i, dev):
            a, b = blocks[i]
            sl = lambda t: None if t is None else t[a:b].to(dev)
            syn = _DDPropagate.apply(cfg, rows[i],
                                     ShotGeom(*(sl(g) for g in geoms)),
                                     *copies[3 * i:3 * (i + 1)], sl(stf))
            return (sl(weights) * fn(sl(obs), syn)).sum()

        return _sum_in_order(_on_mesh(heads, run))

    return loss
