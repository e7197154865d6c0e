"""Synthetic earth-model builders.

A numpy/scipy copy of `sep2023_tpu/models.py` (the port imports no jax);
the Gassmann true model of `twin_experiment_setup(model="rock")` goes
through the port's `rock_physics`, in the run's dtype where the JAX
package's goes through jnp in its x64 setting.

The reference's model grids (Models/*.txt, e.g.
Anomaly_P-WAVE_VELOCITY_101_201.txt, Main-001:78-80) are excluded from its
repository by .gitignore, so the experiment drivers here synthesize
equivalent models programmatically: a layered background with box/Gaussian
anomalies (the twin-experiment setup of notebooks 001-003) and a PCS
(porosity/clay/saturation) reservoir model for the rock-physics experiments
(notebooks 004-005).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from sep2023_tpu_torch import rock_physics as rp


def constant(nz: int, nx: int, value: float) -> np.ndarray:
    return np.full((nz, nx), value, dtype=np.float64)


def layered(nz: int, nx: int, interfaces: Sequence[int],
            values: Sequence[float]) -> np.ndarray:
    """Horizontally layered model: values[i] between interfaces[i-1] and
    interfaces[i] (interfaces in grid rows)."""
    assert len(values) == len(interfaces) + 1
    m = np.full((nz, nx), values[-1], dtype=np.float64)
    prev = 0
    for iface, v in zip(interfaces, values[:-1]):
        m[prev:iface, :] = v
        prev = iface
    return m


def box_anomaly(base: np.ndarray, z0: int, z1: int, x0: int, x1: int,
                delta: float) -> np.ndarray:
    out = base.copy()
    out[z0:z1, x0:x1] += delta
    return out


def gaussian_anomaly(base: np.ndarray, zc: float, xc: float, sigma: float,
                     delta: float) -> np.ndarray:
    nz, nx = base.shape
    z, x = np.mgrid[0:nz, 0:nx]
    return base + delta * np.exp(-((z - zc) ** 2 + (x - xc) ** 2)
                                 / (2.0 * sigma ** 2))


def smooth(model: np.ndarray, sigma: float) -> np.ndarray:
    """Smoothed initial model for twin experiments."""
    return gaussian_filter(model, sigma)


def anomaly_vp_vs_rho(nz: int = 101, nx: int = 201,
                      vp_bg: float = 3000.0, d_vp: float = 200.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Twin-experiment triple with a central box anomaly, shaped like the
    reference's Anomaly_*_101_201 models (Main-001)."""
    vp = constant(nz, nx, vp_bg)
    vp = box_anomaly(vp, nz // 3, nz // 3 + nz // 5,
                     2 * nx // 5, 2 * nx // 5 + nx // 5, d_vp)
    vs = vp / np.sqrt(3.0)
    rho = np.power(vp, 0.25) * 310.0  # Gardner-style (notebook cell 8 uses it)
    return vp, vs, rho


def twin_experiment_setup(head: str, nz: int, nx: int,
                          model: str = "anomaly", dtype=torch.float64):
    """True/initial parameter sets (+ bounds and invertible names) for the
    twin experiments of the reference drivers Main-001..005, per head.

    model='rock' with a velocity head is the Main-005 flow (NO-PCS):
    invert vp/vs/rho directly on data from the Gassmann reservoir model.
    dtype is the run's, the counterpart of the JAX package's x64 switch:
    in float32 the model's two square roots and lam, mu are float32, the
    rest float64, as the JAX CLI computes them without --x64 (jnp in
    rock_physics, numpy here); in float64 all of it is float64, as with
    --x64.  The returned arrays are float64 either way.
    """
    if model == "rock" and head not in ("rock_vrh", "rock_gassmann"):
        phi, cc, sw = (torch.from_numpy(a) for a in reservoir_pcs(nz, nx))
        lam, mu, rho = (a.numpy() for a in
                        rp.pcs_to_lame_gassmann(phi, cc, sw, dtype=dtype))
        vp = np.sqrt((lam + 2 * mu) / rho)
        vs = np.sqrt(mu / rho)
    else:
        vp, vs, rho = anomaly_vp_vs_rho(nz, nx)
    sm = lambda d: {k: smooth(v, 8.0) for k, v in d.items()}
    if head in ("rock_vrh", "rock_gassmann"):
        phi, cc, sw = reservoir_pcs(nz, nx)
        true = dict(phi=phi, cc=cc, sw=sw)
        return (true, sm(true),
                dict(phi=(0.05, 0.4), cc=(0.05, 0.6), sw=(0.2, 1.0)),
                ("phi", "cc", "sw"))
    if head == "lame_rho":
        true = dict(lam=(vp ** 2 - 2 * vs ** 2) * rho, mu=vs ** 2 * rho,
                    rho=rho)
        return true, sm(true), None, ("lam", "mu", "rho")
    if head == "ip_is_rho":
        true = {"ip": rho * vp, "is": rho * vs, "rho": rho}
        return true, sm(true), None, ("ip", "is", "rho")
    if head == "vp_vs_ip":
        true = dict(vp=vp, vs=vs, ip=rho * vp)
        return true, sm(true), None, ("vp", "vs", "ip")
    if head == "vp_vs_is":
        true = {"vp": vp, "vs": vs, "is": rho * vs}
        return true, sm(true), None, ("vp", "vs", "is")
    true = dict(vp=vp, vs=vs, rho=rho)
    bounds = dict(vp=(vp.min() - 500, vp.max() + 500),
                  vs=(vs.min() - 300, vs.max() + 300),
                  rho=(rho.min() - 300, rho.max() + 300))
    return true, sm(true), bounds, ("vp", "vs", "rho")


def overthrust_vp(nz: int, nx: int, v_top: float = 2400.0,
                  v_step: float = 350.0, n_layers: int = 4,
                  fold_amp: float = 0.08, thrust_throw: float = 0.12
                  ) -> np.ndarray:
    """Overthrust-style Vp model: gently folded layers cut by a dipping
    thrust fault that uplifts the hanging wall — a programmatic stand-in
    for the SEG/EAGE Overthrust slice the reference's second fiber-geometry
    generator targets (`DAS_Geometry_Overthrust.m`; its Models/ grids are
    git-ignored upstream).  Amplitudes are fractions of nz."""
    z, x = np.mgrid[0:nz, 0:nx].astype(np.float64)
    # anticline fold of the layer boundaries + thrust offset on a dipping
    # fault x = x_f(z)
    fold = fold_amp * nz * np.sin(np.pi * (x / nx - 0.15))
    fault_x = 0.55 * nx + 0.8 * (z - nz / 2)  # dipping fault trace
    hanging = (x > fault_x).astype(np.float64)
    throw = thrust_throw * nz * hanging
    z_eff = z + fold + throw
    layer = np.clip((z_eff / nz * n_layers).astype(np.int64), 0,
                    n_layers - 1)
    return v_top + v_step * layer.astype(np.float64)


def reservoir_pcs(nz: int = 201, nx: int = 321
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PCS reservoir model for the rock-physics experiments (Main-004/005):
    layered porosity/clay with a hydrocarbon (low-saturation) lens."""
    phi = layered(nz, nx, [nz // 4, nz // 2, 3 * nz // 4],
                  [0.12, 0.18, 0.25, 0.15])
    cc = layered(nz, nx, [nz // 3, 2 * nz // 3], [0.45, 0.25, 0.35])
    sw = constant(nz, nx, 1.0)
    # hydrocarbon lens
    z0, z1 = int(0.52 * nz), int(0.62 * nz)
    x0, x1 = int(0.40 * nx), int(0.60 * nx)
    sw[z0:z1, x0:x1] = 0.35
    return phi, cc, sw
