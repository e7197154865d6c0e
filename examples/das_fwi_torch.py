"""Curved-fiber DAS FWI demo on the PyTorch/CUDA port: invert Vp from
gauge-length-averaged strain measured along buried fiber-optic cables with
directional sensitivity.  Counterpart of `examples/das_fwi.py`.

Pipeline: arc-shaped cables -> per-point (exx, exz, ezz) sensitivity
weights -> weighted strain-rate channels -> gauge averaging -> L2 misfit ->
boundary-saving adjoint -> L-BFGS-B.  The acquisition runs as point
receivers (`cuda_engine.FiberSurvey`) through `parallel.make_cuda_misfit`:
the CUDA kernels on `--device cuda`, their plain PyTorch versions on
`--device cpu`.  There is no second engine branch.

Run:  python examples/das_fwi_torch.py [outdir] [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from sep2023_tpu_torch import das, models, optimize, parallel
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import pad_model
from sep2023_tpu_torch.ops import cuda_engine


NPML = 16
NZ, NX = 60, 100      # physical grid
GAUGE_LENGTH = 100.0


def acquisition():
    """(cfg, survey, das_w, A): three buried arc cables of 21 quadrature
    points each under surface shots, their (R, 3) sensitivity weights and
    the gauge-averaging matrix."""
    cfg = SimConfig(nz=NZ + 2 * NPML, nx=NX + 2 * NPML, dz=10.0, dx=10.0,
                    nt=500, dt=0.001, f0=15.0, npml=NPML,
                    das_channel="weighted")
    cables = [das.arc_fiber(GAUGE_LENGTH, 2.0 / np.pi,
                            center=(cx, 320.0, 0.0))
              for cx in (250.0, 500.0, 750.0)]
    parts = [das.cable_to_receivers(c, cfg.dx, cfg.dz) for c in cables]
    rec_z, rec_x, das_w = (np.concatenate(p) for p in zip(*parts))
    A = das.gauge_matrix(len(cables), das.N_CABLE_PTS, GAUGE_LENGTH)
    src_x = np.arange(10, NX - 10, 15)
    survey = Survey(src_z=np.full(len(src_x), 2), src_x=src_x,
                    rec_z=rec_z, rec_x=rec_x)
    return cfg, survey, das_w, A


def main(outdir="scratch/das_fwi_torch", device="cuda", maxiter=15):
    """Runs the twin experiment and returns (first misfit, final misfit,
    evaluations)."""
    os.makedirs(outdir, exist_ok=True)
    device = torch.device(device)
    cfg, survey, das_w, A = acquisition()
    npml, nzp, nxp = NPML, NZ, NX
    n_shots = survey.n_shots
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(
        torch.float32)
    stf_all = t(ricker(cfg.f0, cfg.nt, cfg.dt)).expand(
        n_shots, cfg.nt).contiguous()

    vp_t, vs_t, rho_t = models.anomaly_vp_vs_rho(nzp, nxp)
    vp_i = models.smooth(vp_t, 6.0)
    vs_pad, rho_pad = pad_model(t(vs_t), npml), pad_model(t(rho_t), npml)

    def to_lame(vp):
        vp_pad = pad_model(vp, npml)
        return ((vp_pad ** 2 - 2 * vs_pad ** 2) * rho_pad,
                vs_pad ** 2 * rho_pad, rho_pad)

    fwd = parallel.make_forward(cfg, survey, use_kernels=True, device=device,
                                das_w=das_w)
    obs = fwd(*to_lame(t(vp_t)), stf_all)
    A32 = t(A)
    obs_g = das.apply_gauge(obs[:, 3], A32)
    print(f"{n_shots} shots x {A.shape[0]} gauge channels "
          f"({survey.n_rec} fiber points)")

    def gauge_l2(obs_g1, syn1):
        r = obs_g1 - das.apply_gauge(syn1[3], A32)
        return 0.5 * torch.sum(r * r)

    loss_d = parallel.make_cuda_misfit(cfg, survey, misfit_fn=gauge_l2,
                                       das_w=das_w)
    w1 = torch.ones(n_shots, device=device)
    plan, _ = parallel._cuda_plan(cfg, survey, das_w)
    print("engine: " + (cuda_engine.plan_engine_name(plan)
                        if device.type == "cuda" else "plain PyTorch (CPU)"))

    def loss(params, stf_a, obs_gauge):
        lam, mu, rho = to_lame(params["vp"])
        return loss_d(lam, mu, rho, stf_a, obs_gauge, w1)

    obj = optimize.ScipyObjective(loss, {"vp": vp_i}, aux=(stf_all, obs_g),
                                  device=device)
    f0 = obj.fun(obj.x0)
    res = optimize.lbfgsb(obj, maxiter=maxiter)
    vp_inv = obj.unpack(res.x)["vp"].cpu().numpy()
    print(f"DAS gauge misfit: {f0:.4e} -> {res.fun:.4e} "
          f"({res.nit} iterations, {obj.n_evals} evaluations)")

    box = vp_t != vp_t[0, 0]
    print(f"anomaly mean update: {vp_inv[box].mean() - vp_t[0, 0]:+.1f} m/s "
          f"(true {vp_t[box].mean() - vp_t[0, 0]:+.1f})")
    np.savez(os.path.join(outdir, "das_fwi_torch.npz"), vp_true=vp_t,
             vp_init=vp_i, vp_inv=vp_inv)
    print("saved", os.path.join(outdir, "das_fwi_torch.npz"))
    return f0, float(res.fun), obj.n_evals


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("outdir", nargs="?", default="scratch/das_fwi_torch")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    main(args.outdir, args.device)
