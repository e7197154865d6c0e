"""Signal processing on seismogram arrays.

PyTorch counterpart of `sep2023_tpu/ops/signal.py`.  Only the taper window
is ported so far (the forward path's wavelet end-taper); band-pass
filtering and the Wiener source update come with the misfits (ROADMAP M3).
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
    if ws.ndim or we.ndim:
        ws = torch.atleast_1d(ws)[..., None]   # (R, 1)
        we = torch.atleast_1d(we)[..., None]
    ramp = max(ratio * nt, 1.0)
    t = torch.arange(nt, dtype=f64)
    up = ((t - ws) / ramp).clamp(0.0, 1.0)
    down = ((we - t) / ramp).clamp(0.0, 1.0)
    w = (torch.sin(0.5 * math.pi * up) ** 2
         * torch.sin(0.5 * math.pi * down) ** 2)
    return w.to(device=device, dtype=dtype)
