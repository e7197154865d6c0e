"""Signal processing on seismogram tensors: trapezoid band-pass filtering,
taper windows, and Wiener spectral source estimation.

PyTorch counterpart of `sep2023_tpu/ops/signal.py` (the reference's
cuFFT-based utilities):
  - sin^2/cos^2 trapezoid band-pass  `cuda_bp_filter1d` (utilities.cu:733-763)
  - taper window                     `cuda_window`     (utilities.cu:790-884)
  - spectral source update           `source_update`   (utilities.cu:1170-1325)
All operate along the trailing (time) axis with torch.fft and are
differentiable, so they compose with the propagators in any misfit chain.
"""
from __future__ import annotations

import math

import torch


def taper_window(nt: int, dt: float, win_start=None, win_end=None,
                 ratio: float = 0.005, *, device=None, dtype=torch.float32):
    """Per-sample taper: 1 inside [win_start, win_end] (in samples) with
    sin^2 ramps of width ratio*nt on both sides (cuda_window,
    utilities.cu:790-884).

    win_start / win_end may be scalars (one window for all traces) or (R,)
    arrays (per-trace windows).  Returns (nt,) for scalars, (R, nt) for
    per-trace bounds.  Computed in float64 and cast to `dtype`."""
    f64 = torch.float64
    ws = torch.as_tensor(0 if win_start is None else win_start, dtype=f64)
    we = torch.as_tensor(nt - 1 if win_end is None else win_end, dtype=f64)
    on = ws.device
    if ws.ndim or we.ndim:
        on = ws.device if ws.ndim else we.device
        ws = torch.atleast_1d(ws)[..., None]   # (R, 1)
        we = torch.atleast_1d(we)[..., None]
    ramp = max(ratio * nt, 1.0)
    t = torch.arange(nt, dtype=f64, device=on)
    up = ((t - ws) / ramp).clamp(0.0, 1.0)
    down = ((we - t) / ramp).clamp(0.0, 1.0)
    w = (torch.sin(0.5 * math.pi * up) ** 2
         * torch.sin(0.5 * math.pi * down) ** 2)
    return w.to(device=device, dtype=dtype)


def bandpass_amplitude(nt: int, dt: float, f0: float, f1: float, f2: float,
                       f3: float, *, device=None, dtype=torch.float64):
    """Trapezoid |H(f)| on the rfft frequencies of nt samples: sin^2 ramp
    f0->f1, flat f1->f2, cos^2 roll-off f2->f3 (the piecewise form of
    utilities.cu:749-758, applied as an amplitude-only zero-phase filter).
    Computed in float64 and cast to `dtype`."""
    f64 = torch.float64
    freq = torch.arange(nt // 2 + 1, dtype=f64) / (dt * nt)
    zero = torch.zeros((), dtype=f64)
    up = torch.where((freq >= f0) & (freq < f1),
                     torch.sin(math.pi / 2.0 * (freq - f0)
                               / max(f1 - f0, 1e-20)), zero)
    flat = torch.where((freq >= f1) & (freq < f2), 1.0, zero)
    down = torch.where((freq >= f2) & (freq < f3),
                       torch.cos(math.pi / 2.0 * (freq - f2)
                                 / max(f3 - f2, 1e-20)), zero)
    return (up + flat + down).to(device=device, dtype=dtype)


def bandpass(data, dt: float, corners):
    """Zero-phase trapezoid band-pass along the last axis.

    corners = (f0, f1, f2, f3) as in the reference's `filter` JSON entry
    (Parameter.cpp:139-177)."""
    H = bandpass_amplitude(data.shape[-1], dt, *corners)
    return apply_bandpass_amplitude(data, H)


def apply_bandpass_amplitude(data, H):
    """Apply a precomputed zero-phase amplitude response H (..., nfreq)
    along the last axis (H broadcasts against data's spectrum)."""
    nt = data.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(data, dim=-1)
                           * H.to(data.device, data.dtype), n=nt, dim=-1)


def source_update_filter(obs, syn, eps: float = 1e-8):
    """Wiener deconvolution filter W(f) = sum conj(S) O / (sum |S|^2 + eps
    max(max den, 1)) estimated over receivers: the spectral source
    correction of `source_update` / `cuda_spectrum_update`
    (utilities.cu:905-978, 1170-1325).  obs/syn: (..., n_rec, nt), summed
    over every axis but time.  Returns the complex filter (nfreq,) to apply
    to the current source wavelet."""
    O = torch.fft.rfft(obs, dim=-1)
    S = torch.fft.rfft(syn, dim=-1)
    axes = tuple(range(O.ndim - 1))
    num = (torch.conj(S) * O).sum(dim=axes)
    den = (S.abs() ** 2).sum(dim=axes)
    scale = torch.clamp(den.max(), min=1.0)
    return num / (den + eps * scale)


def apply_source_filter(stf, W):
    """Apply a spectral filter W (from `source_update_filter`) to a source
    wavelet (nt,) -> corrected wavelet (nt,)."""
    nt = stf.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(stf, dim=-1) * W, n=nt, dim=-1)
