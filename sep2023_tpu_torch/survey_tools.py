"""A numpy copy of `sep2023_tpu/survey_tools.py` (the port imports no jax).

Survey/construction helpers carried over from the reference's legacy
Julia utilities (`Ops/FWI/fwi_util.jl` — capability reference; not on the
reference's Python path but part of its feature surface):

  - vs_bounds_from_cloud : Vs L-BFGS-B bounds derived from a Vp-Vs well-log
    point cloud (cs_bounds_cloud, fwi_util.jl:122-134)
  - compute_rxz          : local sxx/szz source moment ratio from smoothed
    Vp/Vs around each source (computeRsxxzz, fwi_util.jl:174-194)
"""
from __future__ import annotations

import numpy as np


def vs_bounds_from_cloud(vp_img: np.ndarray, cloud: np.ndarray):
    """Vs bounds per pixel from a (3, N) bounds cloud:
    row 0 = vp reference line, row 1 = vs upper line, row 2 = vs lower line
    (linear interpolation).  The upper bound is additionally capped at
    vp/sqrt(2) - 1 (the physical lambda > 0 limit), as the reference does.

    Returns (vs_low, vs_high) arrays shaped like vp_img.
    """
    cloud = np.asarray(cloud, dtype=np.float64)
    order = np.argsort(cloud[0])
    vp_line, vs_hi_line, vs_lo_line = (cloud[0, order], cloud[1, order],
                                       cloud[2, order])
    hi = np.interp(vp_img, vp_line, vs_hi_line)
    lo = np.interp(vp_img, vp_line, vs_lo_line)
    hi = np.minimum(hi, vp_img / np.sqrt(2.0) - 1.0)
    return lo, hi


def energy_trace_weights(obs: np.ndarray, floor: float = 1e-3) -> np.ndarray:
    """Per-trace weights that equalize trace amplitudes, 1/max|trace|
    normalized to unit mean — the capability of the legacy
    `weightObsTraces` (fwi_util.jl:196+).  obs: (..., n_rec, nt); returns
    weights shaped (..., n_rec)."""
    amax = np.abs(obs).max(axis=-1)
    amax = np.maximum(amax, floor * amax.max() + 1e-30)
    w = 1.0 / amax
    return w / w.mean()


def check_reach(cfg, survey, vp_max: float, warn: bool = True):
    """Shots whose NEAREST receiver lies beyond the maximum wave reach
    vp_max * (nt-1) * dt record only round-off noise: their misfit is zero
    by construction and an inversion silently ignores them.  Returns the
    list of unreachable shot indices and (by default) warns.

    The reference has no such guard (a too-short nSteps in para_file.json
    fails silently, `Src_Rec.cu:87-116` just uploads the geometry); this
    closes a trap the straight-line bound catches conservatively — a real
    first arrival is never earlier than the straight ray at vp_max."""
    import warnings

    reach = float(vp_max) * (cfg.nt - 1) * cfg.dt
    rz = np.asarray(survey.rec_z)
    rx = np.asarray(survey.rec_x)
    src_z = np.asarray(survey.src_z)
    src_x = np.asarray(survey.src_x)
    bad = []
    for s in range(len(src_z)):
        z = rz if rz.ndim == 1 else rz[s]
        x = rx if rx.ndim == 1 else rx[s]
        d = np.hypot((z - src_z[s]) * cfg.dz, (x - src_x[s]) * cfg.dx)
        if float(d.min()) > reach:
            bad.append(s)
    if bad and warn:
        warnings.warn(
            f"shots {bad} cannot reach any receiver within nt*dt "
            f"({reach:.0f} m at vp_max={vp_max:.0f}): their traces are "
            f"numerically zero — increase nt or move receivers",
            stacklevel=2)
    return bad


def compute_rxz(vp: np.ndarray, vs: np.ndarray, src_z: np.ndarray,
                src_x: np.ndarray) -> np.ndarray:
    """sxx/szz moment ratio per source from the 9x9 neighborhood average of
    Vp/Vs around the source (center excluded):
    rxz = vp_ave^2 / (vp_ave^2 - 2 vs_ave^2)."""
    vp_pad = np.pad(vp, 4, mode="edge")
    vs_pad = np.pad(vs, 4, mode="edge")
    mask = np.ones((9, 9))
    mask[4, 4] = 0.0
    rxz = np.zeros(len(src_z), dtype=np.float64)
    for i, (z, x) in enumerate(zip(np.asarray(src_z) + 4,
                                   np.asarray(src_x) + 4)):
        vp_ave = np.mean(vp_pad[z - 4:z + 5, x - 4:x + 5] * mask)
        vs_ave = np.mean(vs_pad[z - 4:z + 5, x - 4:x + 5] * mask)
        rxz[i] = vp_ave ** 2 / (vp_ave ** 2 - 2.0 * vs_ave ** 2)
    return rxz
