"""A numpy copy of `sep2023_tpu/analytic.py` (the port imports no jax).

Aki & Richards (2002) analytical moment-tensor solutions in homogeneous
isotropic media — the framework's numerics oracle.

Re-derivation (NOT a port) of `DAS_Waveform_Modeling/src/analyticalSolution.py`:

  * `displacement_3d` evaluates eq. (4.29)-type near / intermediate / far
    field terms, fully VECTORIZED over a batch of receivers — the reference
    evaluates a triple i,j,k loop per receiver and parallelizes the 2D line
    integral with joblib over ~1000 processes (analyticalSolution.py:242-344,
    wall-time 4-9 minutes per trace set).  Here the same integral is a batched
    einsum finishing in < 1 s.
  * The near-field time integral  int_{r/vp}^{r/vs} tau * M(t - tau) dtau
    (the reference's O(nt * ntau) double loop, STF0,
    analyticalSolution.py:450-490) is evaluated in CLOSED FORM using the
    elementary antiderivatives of the Ricker wavelet:
        F1(w) = int M = M0 * w * exp(-e w^2)
        F2(s) = int s M ds = M0 * [exp(-e w^2)(w^2 + 1/(2e)) + t0 F1(w)],
    with w = s - t0, e = (pi f0)^2, so
        int_a^b tau M(t-tau) dtau = t [F1(t-a)-F1(t-b)] - [F2(t-a)-F2(t-b)].
  * `displacement_2d` integrates the 3D solution along the fiber-parallel
    y-axis (line source), same discretization choices as the reference
    (dy = vs/(20 f0), y-range +-1.5 vp tmax; analyticalSolution.py:299-344).
  * `solution` dispatches dim x {displacement, velocity, acceleration,
    strain} with the reference's central-difference strain offsets
    (+-0.5 m in 3D, +-10 m in 2D).
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Source time functions (Ricker family, delay 1.2/f0)
# ---------------------------------------------------------------------------

def stf_ricker(t, f0, M0=1.0):
    t0 = 1.2 / f0
    e = (np.pi * f0) ** 2
    w = t - t0
    return M0 * (1.0 - 2.0 * e * w ** 2) * np.exp(-e * w ** 2)


def stf_ricker_d1(t, f0, M0=1.0):
    """d/dt Ricker (analyticalSolution.py:388-416)."""
    t0 = 1.2 / f0
    pf = np.pi * f0
    w = t - t0
    return M0 * (-2.0) * pf ** 2 * w * (3.0 - 2.0 * (pf * w) ** 2) * np.exp(-(pf * w) ** 2)


def stf_ricker_d2(t, f0, M0=1.0):
    t0 = 1.2 / f0
    pf = np.pi * f0
    w = t - t0
    return M0 * (-6.0 * pf ** 2 + 24.0 * pf ** 4 * w ** 2
                 - 8.0 * pf ** 6 * w ** 4) * np.exp(-(pf * w) ** 2)


def _F1(s, f0):
    """Antiderivative of the (unit) Ricker: int M(u) du evaluated at u=s."""
    t0 = 1.2 / f0
    e = (np.pi * f0) ** 2
    w = s - t0
    return w * np.exp(-e * w ** 2)


def _F2(s, f0):
    """Antiderivative of s * M(s)."""
    t0 = 1.2 / f0
    e = (np.pi * f0) ** 2
    w = s - t0
    return np.exp(-e * w ** 2) * (w ** 2 + 0.5 / e) + t0 * _F1(s, f0)


def near_field_integral(t, a, b, f0, M0=1.0):
    """int_a^b tau * M(t - tau) dtau in closed form.  t: (..., nt); a, b:
    broadcastable (e.g. per-receiver r/vp, r/vs)."""
    ta, tb = t - a, t - b
    return M0 * (t * (_F1(ta, f0) - _F1(tb, f0)) - (_F2(ta, f0) - _F2(tb, f0)))


# ---------------------------------------------------------------------------
# Moment tensor
# ---------------------------------------------------------------------------

def moment_tensor(strike, dip, rake):
    """Double-couple moment tensor from strike/dip/rake in degrees
    (analyticalSolution.py:493-542)."""
    d = np.pi / 180.0
    cs, ss = np.cos(strike * d), np.sin(strike * d)
    cd, sd = np.cos(dip * d), np.sin(dip * d)
    cr, sr = np.cos(rake * d), np.sin(rake * d)
    slip = np.array([cr * cs + sr * cd * ss, cr * ss - sr * cd * cs, -sr * sd])
    normal = np.array([-sd * ss, sd * cs, -cd])
    return np.outer(slip, normal) + np.outer(normal, slip)


# ---------------------------------------------------------------------------
# Displacement fields
# ---------------------------------------------------------------------------

def displacement_3d(vp, vs, rho, xyz, t, f0, M0, M):
    """3D displacement for a moment-tensor point source.

    xyz: (B, 3) receiver offsets from the source; t: (nt,).
    Returns U: (B, 3, nt).
    """
    xyz = np.atleast_2d(np.asarray(xyz, dtype=np.float64))
    t = np.asarray(t, dtype=np.float64)
    M = np.asarray(M, dtype=np.float64)

    r0 = np.linalg.norm(xyz, axis=1)                       # (B,)
    r = xyz / r0[:, None]                                  # (B, 3) unit vectors

    q = np.einsum("bi,ij,bj->b", r, M, r)                  # r.M.r
    Mr = r @ M.T                                           # (B,3): sum_k M_ik r_k
    rM = r @ M                                             # (B,3): sum_j r_j M_ji
    trM = np.trace(M)

    AN = 15.0 * r * q[:, None] - 3.0 * r * trM - 3.0 * rM - 3.0 * Mr
    AIP = 6.0 * r * q[:, None] - r * trM - rM - Mr
    AIS = -(6.0 * r * q[:, None] - r * trM - rM - 2.0 * Mr)
    AFP = r * q[:, None]
    AFS = -(r * q[:, None] - Mr)

    CN = 1.0 / (4.0 * np.pi * rho)
    CIP = CN / vp ** 2
    CIS = CN / vs ** 2
    CFP = CN / vp ** 3
    CFS = CN / vs ** 3

    tp = t[None, :] - (r0 / vp)[:, None]                   # (B, nt) retarded times
    ts = t[None, :] - (r0 / vs)[:, None]
    s0 = near_field_integral(t[None, :], (r0 / vp)[:, None],
                             (r0 / vs)[:, None], f0, M0)
    s1 = stf_ricker(tp, f0, M0)
    s2 = stf_ricker(ts, f0, M0)
    s3 = stf_ricker_d1(tp, f0, M0)
    s4 = stf_ricker_d1(ts, f0, M0)

    inv = 1.0 / r0
    U = (CN * (inv ** 4)[:, None, None] * AN[:, :, None] * s0[:, None, :]
         + CIP * (inv ** 2)[:, None, None] * AIP[:, :, None] * s1[:, None, :]
         + CIS * (inv ** 2)[:, None, None] * AIS[:, :, None] * s2[:, None, :]
         + CFP * inv[:, None, None] * AFP[:, :, None] * s3[:, None, :]
         + CFS * inv[:, None, None] * AFS[:, :, None] * s4[:, None, :])
    return U


def displacement_2d(vp, vs, rho, x, z, t, f0, M0, M, oversample: float = 1.0):
    """2D (line-source) displacement: y-integration of the 3D solution with
    the reference's quadrature (dy = vs/(20 f0), range +-1.5 vp tmax,
    analyticalSolution.py:309-331).  Returns U: (3, nt)."""
    t = np.asarray(t, dtype=np.float64)
    tmax = t[-1]
    dy = 1.0 / (4.0 * f0) * vs / (5.0 * oversample)
    ny_min = int(-vp * tmax * 1.5 / dy) - 1
    ny_max = int(vp * tmax * 1.5 / dy) + 1
    recs = np.arange(ny_min, ny_max)
    ys = -(recs - 1.0) * dy
    xyz = np.stack([np.full_like(ys, x), ys, np.full_like(ys, z)], axis=1)
    U = displacement_3d(vp, vs, rho, xyz, t, f0, M0, M)     # (B, 3, nt)
    return U.sum(axis=0) * dy


def solution(vp, vs, rho, x, y, z, tmin, tmax, dt, f0, M0, M,
             dim="3D", comp="displacement", strike=None, dip=None, rake=None):
    """Dispatch mirroring the reference API (analyticalSolution.py:29-239).

    Returns a dict with 't' plus the requested components, e.g. Ux/Uy/Uz,
    Vx/Vz, Ax/Az, or the strain components Exx/Eyy/Ezz/Exy/Exz/Eyz (3D) /
    Exx/Ezz/Exz (2D).
    """
    if strike is not None and dip is not None and rake is not None:
        M = moment_tensor(strike, dip, rake)
    t = np.arange(tmin, tmax + dt, dt)
    out = {"t": t}

    if dim == "3D":
        if comp in ("displacement", "velocity", "acceleration"):
            U = displacement_3d(vp, vs, rho, [[x, y, z]], t, f0, M0, M)[0]
            if comp == "displacement":
                out["Ux"], out["Uy"], out["Uz"] = U
            elif comp == "velocity":
                out["Vx"], out["Vy"], out["Vz"] = np.gradient(U, dt, axis=1)
            else:
                A = np.gradient(np.gradient(U, dt, axis=1), dt, axis=1)
                out["Ax"], out["Ay"], out["Az"] = A
        elif comp == "strain":
            h = 0.5  # central-difference offset (analyticalSolution.py:183)
            pts = np.array([
                [x - h, y, z], [x + h, y, z],
                [x, y - h, z], [x, y + h, z],
                [x, y, z - h], [x, y, z + h],
            ])
            U = displacement_3d(vp, vs, rho, pts, t, f0, M0, M)
            dUdx = (U[1] - U[0]) / (2 * h)
            dUdy = (U[3] - U[2]) / (2 * h)
            dUdz = (U[5] - U[4]) / (2 * h)
            out["Exx"], out["Eyy"], out["Ezz"] = dUdx[0], dUdy[1], dUdz[2]
            out["Exy"] = 0.5 * (dUdx[1] + dUdy[0])
            out["Exz"] = 0.5 * (dUdx[2] + dUdz[0])
            out["Eyz"] = 0.5 * (dUdy[2] + dUdz[1])
    elif dim == "2D":
        if comp in ("displacement", "velocity", "acceleration"):
            U = displacement_2d(vp, vs, rho, x, z, t, f0, M0, M)
            if comp == "displacement":
                out["Ux"], out["Uz"] = U[0], U[2]
            elif comp == "velocity":
                V = np.gradient(U, dt, axis=1)
                out["Vx"], out["Vz"] = V[0], V[2]
            else:
                A = np.gradient(np.gradient(U, dt, axis=1), dt, axis=1)
                out["Ax"], out["Az"] = A[0], A[2]
        elif comp == "strain":
            h = 10.0  # reference uses 10 m offsets in 2D (analyticalSolution.py:224)
            Ux1 = displacement_2d(vp, vs, rho, x - h, z, t, f0, M0, M)
            Ux2 = displacement_2d(vp, vs, rho, x + h, z, t, f0, M0, M)
            Uz1 = displacement_2d(vp, vs, rho, x, z - h, t, f0, M0, M)
            Uz2 = displacement_2d(vp, vs, rho, x, z + h, t, f0, M0, M)
            out["Exx"] = (Ux2[0] - Ux1[0]) / (2 * h)
            out["Ezz"] = (Uz2[2] - Uz1[2]) / (2 * h)
            out["Exz"] = 0.5 * ((Ux2[2] - Ux1[2]) / (2 * h)
                                + (Uz2[0] - Uz1[0]) / (2 * h))
    else:
        raise ValueError(f"dim must be '2D' or '3D', got {dim}")
    return out
