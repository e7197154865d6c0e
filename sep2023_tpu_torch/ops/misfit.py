"""Misfit functionals on (..., 4, n_rec, nt) seismogram tensors.

PyTorch counterpart of the L2 part of `sep2023_tpu/ops/misfit.py`.  The
reference computes residuals with the first time sample zeroed (`gpuMinus`,
utilities.cu:154-167), sums squares per channel (`cuda_cal_objective`,
utilities.cu:169-205) and keeps only the ett (DAS) term in the objective,
scaled by 0.5 (`libCUFD.cu:410-427, 776-779`).  Gradients flow back into the
propagator as data cotangents.  The preprocessed L2 and the
cross-correlation misfit are ROADMAP M3.
"""
from __future__ import annotations

from typing import Sequence

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
    r = residual(obs, syn)[..., [_CH_INDEX[c] for c in channels], :, :]
    if weights is not None:
        r = r * weights
    return 0.5 * (r * r).sum()
