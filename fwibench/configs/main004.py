"""The plain reference of `main004`: the published PCS reservoir model of
Main-004 (layered porosity and clay content, water saturation 1 with a
hydrocarbon lens of 0.35) and the rock_gassmann head (Gassmann fluid
substitution on Dupuy's drained moduli, the reference's 0.75 shear term in
vp^2, lam formed from vp and vs)."""
import numpy as np
import torch

K_QUARTZ, K_CLAY, K_WATER, K_HYDRO = 37.00e9, 21.00e9, 2.25e9, 0.04e9
MU_QUARTZ, MU_CLAY = 44.00e9, 10.00e9
RHO_QUARTZ, RHO_CLAY, RHO_WATER, RHO_HYDRO = 2.65e3, 2.55e3, 1.00e3, 0.10e3
CS = 20.0


def _layered(nz, nx, interfaces, values):
    m = np.full((nz, nx), values[-1], dtype=np.float64)
    prev = 0
    for iface, v in zip(interfaces, values[:-1]):
        m[prev:iface, :] = v
        prev = iface
    return m


def true_model(nz: int, nx: int) -> dict:
    """(phi, cc, sw) on the physical grid, float64."""
    phi = _layered(nz, nx, [nz // 4, nz // 2, 3 * nz // 4],
                   [0.12, 0.18, 0.25, 0.15])
    cc = _layered(nz, nx, [nz // 3, 2 * nz // 3], [0.45, 0.25, 0.35])
    sw = np.full((nz, nx), 1.0)
    sw[int(0.52 * nz):int(0.62 * nz), int(0.40 * nx):int(0.60 * nx)] = 0.35
    return {"phi": phi, "cc": cc, "sw": sw}


def _avg(p1, p2, v1):
    return p1 * v1 + p2 * (1.0 - v1)


def _voigt(p1, p2, v1):
    return v1 * p1 + (1.0 - v1) * p2


def to_lame(phi, cc, sw):
    rho_f = _avg(RHO_WATER, RHO_HYDRO, sw)
    k_f = _avg(K_WATER, K_HYDRO, sw)
    k_s = _voigt(K_CLAY, K_QUARTZ, cc)
    mu_s = _voigt(MU_CLAY, MU_QUARTZ, cc)
    rho_s = _avg(RHO_CLAY, RHO_QUARTZ, cc)
    k_d = k_s * ((1 - phi) / (1 + CS * phi))
    mu_d = mu_s * ((1 - phi) / (1 + 1.5 * CS * phi))
    delta = ((1 - phi) / phi) * (k_f / k_s) * (1 - k_d / (k_s - k_s * phi))
    k_u = ((phi * k_d + (1 - (1 + phi) * (k_d / k_s)) * k_f)
           / (phi * (1 + delta)))
    rho = _avg(rho_f, rho_s, phi)
    vp = torch.sqrt((k_u + 0.75 * mu_d) / rho)
    vs = torch.sqrt(mu_d / rho)
    return rho * (vp ** 2 - 2.0 * vs ** 2), rho * vs ** 2, rho
