"""DAS modeling walk-through on the PyTorch/CUDA port, the counterpart of
`examples/das_modeling.py` (the DAS_Waveform_Modeling notebook flows):

1. analytical DAS gauge-length responses for fibers of varying curvature and
   quadrature order (Fig-2-3-Analytical-DAS-Waveform.ipynb)
2. numerical solver vs analytical 2D solution (000-Solver-Benchmark.ipynb),
   with the wavefield snapshots of the CPU solver's save_wavefield, through
   `cuda_engine.snapshots_cuda_plan`: the forward kernel on `--device cuda`,
   its plain PyTorch version on `--device cpu`

Run:  python examples/das_modeling_torch.py [outdir] [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from sep2023_tpu_torch import analytic, das
from sep2023_tpu_torch.config import SimConfig, ricker
from sep2023_tpu_torch.medium import Medium
from sep2023_tpu_torch.ops import cuda_engine


def quadrature_study():
    """Max relative error of 1-, 3- and 7-point quadrature against 21 points
    for three gauge lengths and three curvatures; returns them by (gauge
    length, fiber)."""
    vp, vs, rho, f0, M0 = 3000.0, 1500.0, 2500.0, 25.0, 1e15
    M = np.eye(3)
    out = {}
    print("DAS quadrature-convergence study (max rel error vs 21-pt):")
    for gl in (10.0, 20.0, 50.0):
        for r_gl, name in ((1.0 / np.pi, "curvy"), (2.0 / np.pi, "medium"),
                           (1e10 / np.pi, "straight")):
            cable = das.arc_fiber(gl, r_gl, center=(120.0, 140.0, 100.0))
            kw = dict(tmin=0.0, tmax=0.3, dt=0.002, f0=f0, M0=M0, M=M)
            full = das.das_response(vp, vs, rho, gl, cable, 21, (0, 0, 0), **kw)
            errs = []
            for nq in (1, 3, 7):
                r = das.das_response(vp, vs, rho, gl, cable, nq, (0, 0, 0), **kw)
                errs.append(np.abs(r - full).max() / np.abs(full).max())
            out[(gl, name)] = errs
            print(f"  GL={gl:5.1f} {name:9s}: nq=1 {errs[0]:.3f}  "
                  f"nq=3 {errs[1]:.3f}  nq=7 {errs[2]:.3f}")
    return out


NPML = 24
SRC = (NPML + 30, NPML + 60)
REC = (NPML + 110, NPML + 160)   # 800 m down, 1000 m across


def solver_problem(device):
    """(cfg, plan, (lam, mu, rho, stf, src_z, src_x, rxz)) of the benchmark:
    a homogeneous 208x288 padded grid (vp 4000, vs vp/sqrt 3, rho 2500),
    10 m, 1 ms, nt=700, one explosive source and one receiver."""
    cfg = SimConfig(nz=160 + 2 * NPML, nx=240 + 2 * NPML, dz=10.0, dx=10.0,
                    nt=700, dt=0.001, f0=10.0, npml=NPML)
    vp = torch.full((cfg.nz, cfg.nx), 4000.0, device=device)
    lam, mu, rho = Medium(vp, vp / np.sqrt(3.0),
                          torch.full_like(vp, 2500.0)).to_lame()
    stf = torch.as_tensor(ricker(cfg.f0, cfg.nt, cfg.dt, amp=1.0),
                          device=device).to(torch.float32)[None].contiguous()
    plan = cuda_engine.plan_fast_path(cfg, [REC[0]], [REC[1]])
    return cfg, plan, (lam.contiguous(), mu.contiguous(), rho, stf,
                       [SRC[0]], [SRC[1]], [1.0])


def solver_vs_analytic(outdir, device="cuda"):
    """The forward with snapshots every 25 steps against the analytic 2D
    displacement at the receiver; prints and returns the correlation of
    vz with -Uz, with the traces (4, 1, used + 1), the analytic solution
    and the vz movie."""
    device = torch.device(device)
    cfg, plan, inputs = solver_problem(device)
    data, snaps = cuda_engine.snapshots_cuda_plan(plan, *inputs,
                                                  save_every=25)
    data = data[0].cpu().numpy()
    snaps_vz = snaps[:, 0, 0].cpu().numpy()
    n = data.shape[-1]
    t = np.arange(n) * cfg.dt
    U = analytic.displacement_2d(4000.0, 4000.0 / np.sqrt(3.0), 2500.0,
                                 1000.0, 800.0, t, cfg.f0, 1e16, np.eye(3))
    c = np.corrcoef(data[2, 0], -U[2][:n])[0, 1]
    print(f"numerical vz vs analytical Uz correlation: {c:.4f}")
    np.savez(f"{outdir}/solver_vs_analytic.npz", data=data, analytic=U,
             snaps_vz=snaps_vz)
    print(f"saved traces + wavefield movie to {outdir}/solver_vs_analytic.npz")
    return {"corr": float(c), "data": data, "analytic": U, "t": t,
            "snaps_vz": snaps_vz}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("outdir", nargs="?", default="/tmp")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    quadrature_study()
    solver_vs_analytic(args.outdir, args.device)
