"""Misfit functionals on (..., 4, n_rec, nt) seismogram tensors.

PyTorch counterpart of `sep2023_tpu/ops/misfit.py`.  The reference computes
residuals with the first time sample zeroed (`gpuMinus`,
utilities.cu:154-167), sums squares per channel (`cuda_cal_objective`,
utilities.cu:169-205) and keeps only the ett (DAS) term in the objective,
scaled by 0.5 (`libCUFD.cu:410-427, 776-779`).  `make_preprocessed_l2` adds
the reference's data conditioning (taper window, band-pass, per-trace
windows and weights) and the normalized cross-correlation objective.
Gradients flow back into the propagator as data cotangents.
"""
from __future__ import annotations

from typing import Sequence

import torch

from sep2023_tpu_torch import spans
from sep2023_tpu_torch.ops import signal as sg

_CH_INDEX = {"pr": 0, "vx": 1, "vz": 2, "ett": 3}


def residual(obs, syn):
    """obs - syn with the first time sample zeroed (utilities.cu:158-163)."""
    r = obs - syn
    r[..., 0] = 0.0
    return r


def l2_misfit(obs, syn, channels: Sequence[str] = ("ett",), weights=None):
    """0.5 * sum of squared residuals over the selected channels (default:
    ett only, matching `libCUFD.cu:427`).  obs/syn are (4, R, nt) or
    (S, 4, R, nt)."""
    ch = spans.h2d(torch.tensor([_CH_INDEX[c] for c in channels],
                                device=obs.device))
    r = residual(obs, syn)[..., ch, :, :]
    if weights is not None:
        r = r * weights
    return 0.5 * (r * r).sum()


def trace_normalize(d, eps=1e-12):
    """Each trace (last axis) over its L2 norm plus eps."""
    n = torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    return d / (n + eps)


def normalized_crosscorr_misfit(obs, syn, channels: Sequence[str] = ("ett",)):
    """Global-correlation (normalized cross-correlation) misfit,
    1 - <obs_hat, syn_hat> per trace, summed: the capability behind the
    reference's if_cross_misfit flag (`utilities.cu:1011-1113`).  obs/syn
    are (4, R, nt) or (S, 4, R, nt)."""
    idx = [_CH_INDEX[c] for c in channels]
    o = trace_normalize(obs[..., idx, :, :])
    s = trace_normalize(syn[..., idx, :, :])
    return (1.0 - (o * s).sum(dim=-1)).sum()


def make_preprocessed_l2(channels=("ett",), dt=None, filter_corners=None,
                         window=None, win_ratio=0.005, per_trace=False,
                         objective="l2", dynamic_bandpass=False):
    """Misfit with the reference's optional data conditioning applied
    identically to observed and synthetic data: taper window (`cuda_window`,
    utilities.cu:790-884; para flag if_win), trapezoid band-pass
    (`bp_filter1d`, utilities.cu:733-763; para flag filter), per-trace
    weights.  The chain is differentiable, so the adjoint source includes
    the re-filter/re-window steps the reference applies to the residual
    (`libCUFD.cu:444-457`).

    Returns the per-shot objective of the JAX package,
        loss(obs, syn[, win_start, win_end, trace_weights][, bph])
    on (4, R, nt) data, returning a scalar.  per_trace=True adds the
    survey-JSON per-trace conditioning (`Src_Rec.cu:145-200`): (R,) sample
    windows, which supersede `window`, and (R,) trace weights.
    dynamic_bandpass=True adds a trailing (nfreq,) amplitude response `bph`
    (signal.bandpass_amplitude) in place of the static `filter_corners`.
    objective: 'l2' or 'xcorr' (normalized cross-correlation,
    if_cross_misfit, utilities.cu:1011-1113).

    loss.batched is the same objective on a whole chunk: (S, 4, R, nt)
    data and aux with a leading shot axis ((S, R) windows and weights,
    (S, nfreq) bph), returning the (S,) per-shot values.  The loss builders
    of `parallel` use it in place of a loop over shots.  Only the selected
    channels are conditioned: each channel's conditioning is independent of
    the others', so the values are those of the JAX package's order."""
    idx = [_CH_INDEX[c] for c in channels]
    if objective not in ("l2", "xcorr"):
        raise ValueError(f"objective must be 'l2' or 'xcorr', got "
                         f"{objective!r}")

    def batched(obs, syn, *aux):
        # (S, C, R, nt) of the selected channels
        obs, syn = obs[:, idx], syn[:, idx]
        aux = list(aux)
        nt = obs.shape[-1]
        if per_trace:
            win_start, win_end, tw = aux[:3]
            w = sg.taper_window(nt, dt, win_start, win_end, ratio=win_ratio,
                                device=obs.device, dtype=obs.dtype)
            obs, syn = obs * w[:, None], syn * w[:, None]
        elif window is not None:
            w = sg.taper_window(nt, dt, window[0], window[1],
                                ratio=win_ratio, device=obs.device,
                                dtype=obs.dtype)
            obs, syn = obs * w, syn * w
        if filter_corners is not None:
            obs = sg.bandpass(obs, dt, filter_corners)
            syn = sg.bandpass(syn, dt, filter_corners)
        if dynamic_bandpass:
            bph = aux[-1][:, None, None, :]
            obs = sg.apply_bandpass_amplitude(obs, bph)
            syn = sg.apply_bandpass_amplitude(syn, bph)
        if per_trace:
            tw = tw[:, None, :, None]
            obs, syn = obs * tw, syn * tw
        if objective == "l2":
            r = residual(obs, syn)
            return 0.5 * (r * r).sum(dim=(1, 2, 3))
        o, s = trace_normalize(obs), trace_normalize(syn)
        return (1.0 - (o * s).sum(dim=-1)).sum(dim=(1, 2))

    def loss(obs, syn, *aux):
        return batched(obs[None], syn[None], *(a[None] for a in aux))[0]

    loss.batched = batched
    return loss
