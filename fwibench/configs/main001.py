"""The plain reference of `main001`: the published true model of
Main-001 (a 3000 m/s background with a +200 m/s box anomaly, vs = vp/sqrt(3),
Gardner-style rho = 310 vp^0.25) and the vp_vs_rho head."""
import numpy as np


def true_model(nz: int, nx: int) -> dict:
    """(vp, vs, rho) on the physical grid, float64."""
    vp = np.full((nz, nx), 3000.0)
    vp[nz // 3:nz // 3 + nz // 5, 2 * nx // 5:2 * nx // 5 + nx // 5] += 200.0
    vs = vp / np.sqrt(3.0)
    rho = np.power(vp, 0.25) * 310.0
    return {"vp": vp, "vs": vs, "rho": rho}


def to_lame(vp, vs, rho):
    """lam = (vp^2 - 2 vs^2) rho, mu = vs^2 rho."""
    return (vp ** 2 - 2.0 * vs ** 2) * rho, vs ** 2 * rho, rho
