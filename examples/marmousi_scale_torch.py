"""Marmousi-scale twin-experiment FWI on the PyTorch/CUDA port, the
counterpart of `examples/marmousi_scale.py`.

A 750x2000-cell (7.5 km x 20 km at dz=dx=10 m) overthrust-style model with
three Gaussian vp anomalies, 814x2064 padded, inverted end to end on one
card: observed data from the true model through `parallel.make_forward`,
then L-BFGS-B from the smoothed anomaly-free background with gradients from
the chunked `parallel.make_cuda_misfit` (shot_chunk shots in flight, the
gradient accumulator `_chunked_sum`).  The CUDA kernels run on `--device
cuda` at this size; `--device cpu` runs their plain versions, for small
overrides only.

This is the reference's twin-experiment design (anomalies on a known
background, Main-001-FWI-Anomaly-Vp-Vs-Den.py:137-154) at Marmousi scale:
the +-250 m/s blobs (sigma ~400 m) sit within the 6 Hz transmission
resolution (lambda/2 ~ 225 m), so the in-anomaly mean |vp err| drops
within tens of iterations, a model metric that shows recovery, not just a
falling misfit.

Run:  python examples/marmousi_scale_torch.py [outdir] [n_iters]
          [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from sep2023_tpu_torch import models, optimize, parallel
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import pad_model, pad_model_np


def problem(nz=750, nx=2000, nt=2001, n_shots=24, npml=32,
            smooth_cells=None, f0=6.0):
    """(cfg, survey, vp_true, vp_bg, vp_init, anomaly mask, receiver row):
    the overthrust background, the truth with its three Gaussian blobs, the
    gently smoothed background without them as the start, shots across the
    top and receivers on a deep row (DAS-style)."""
    dh, dt = 10.0, 0.001         # 2 s window (receivers at 0.6 nz ~ 1.5 s)
    cfg = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=dh, dx=dh,
                    nt=nt, dt=dt, f0=float(f0), npml=npml)
    vp_bg = models.overthrust_vp(nz, nx, v_top=2600.0, v_step=300.0)
    sig_b = max(5.0, 0.055 * nz)
    vp_t = vp_bg
    for zf, xf, amp in ((0.22, 0.32, 250.0), (0.38, 0.52, -250.0),
                        (0.30, 0.70, 200.0)):
        vp_t = models.gaussian_anomaly(vp_t, zf * nz, xf * nx, sig_b, amp)
    anom_mask = np.abs(vp_t - vp_bg) > 25.0
    if smooth_cells is None:
        smooth_cells = max(6.0, 24.0 * nz / 750.0)
    vp_0 = models.smooth(vp_bg, float(smooth_cells))
    cfg.check_stability(float(vp_t.max()))
    mx = max(4, nx // 50)
    src_x = np.linspace(mx, nx - mx, n_shots).astype(np.int64)
    rec_row = int(0.6 * nz)
    survey = Survey(src_z=np.full(len(src_x), 2), src_x=src_x,
                    rec_z=np.full(nx - 2 * (mx // 2), rec_row),
                    rec_x=np.arange(mx // 2, nx - mx // 2))
    return cfg, survey, vp_t, vp_bg, vp_0, anom_mask, rec_row


RHO = 2300.0


def to_lame(vp_pad):
    """(lam, mu, rho) of vp with vs = vp / sqrt 3 and a constant rho."""
    vs_pad = vp_pad / np.sqrt(3.0)
    rho = torch.full_like(vp_pad, RHO)
    return (vp_pad ** 2 - 2 * vs_pad ** 2) * rho, vs_pad ** 2 * rho, rho


def objective(cfg, survey, vp_t, vp_0, shot_chunk, device):
    """The example's ScipyObjective: the L2 misfit of ett through the
    chunked make_cuda_misfit, from observed data of the true model through
    make_forward with the same chunks."""
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(
        torch.float32)
    npml = cfg.npml
    stf = t(ricker(cfg.f0, cfg.nt, cfg.dt)).expand(
        survey.n_shots, cfg.nt).contiguous()
    w = torch.ones(survey.n_shots, device=device)
    gen = parallel.make_forward(cfg, survey, use_kernels=True,
                                shot_chunk=shot_chunk, device=device)
    obs = gen(*(a.contiguous() for a in to_lame(t(pad_model_np(vp_t,
                                                                npml)))),
              stf)
    data_loss = parallel.make_cuda_misfit(cfg, survey, shot_chunk=shot_chunk)

    def loss(params, stf_, obs_):
        return data_loss(*to_lame(pad_model(params["vp"], npml)), stf_, obs_,
                         w)

    return optimize.ScipyObjective(loss, {"vp": vp_0}, aux=(stf, obs),
                                   device=device)


def main(outdir="scratch/marmousi_scale", n_iters=30, nz=750, nx=2000,
         nt=2001, n_shots=24, npml=32, smooth_cells=None, shot_chunk=2,
         f0=6.0, device="cuda"):
    """Defaults are the Marmousi-scale run on the card; the smaller
    overrides let the same machinery smoke-test on the CPU.  Returns the
    metrics dict it prints (misfit and in-anomaly model error, both of
    which must improve; the illuminated-zone and whole-model errors beside
    them; the evaluations, the seconds in L-BFGS-B and in the observed
    data's forward)."""
    os.makedirs(outdir, exist_ok=True)
    n_iters, nz, nx, nt, n_shots, npml, shot_chunk = (
        int(v) for v in (n_iters, nz, nx, nt, n_shots, npml, shot_chunk))
    device = torch.device(device)
    cfg, survey, vp_t, vp_bg, vp_0, anom_mask, rec_row = problem(
        nz, nx, nt, n_shots, npml, smooth_cells, f0)
    print(f"grid {cfg.nz}x{cfg.nx} padded, nt={nt}, {n_shots} shots in "
          f"chunks of {shot_chunk} (auto_shot_chunk would take "
          f"{parallel.auto_shot_chunk(cfg, n_shots, device=device)})",
          flush=True)

    # the illuminated zone: between the surface sources and the receiver
    # line, inside the lateral source spread
    mx = max(4, nx // 50)
    zone = (slice(4, rec_row), slice(mx, nx - mx))
    zone_err = lambda vp: float(np.abs(vp - vp_t)[zone].mean())
    anom_err = lambda vp: float(np.abs(vp - vp_t)[anom_mask].mean())

    print("generating observed data ...", flush=True)
    t0 = time.perf_counter()
    obj = objective(cfg, survey, vp_t, vp_0, shot_chunk, device)
    seconds_data = time.perf_counter() - t0
    print(f"  {n_shots} shots in {seconds_data:.1f}s", flush=True)
    err_hist = [anom_err(vp_0)]

    def track(xk):
        err_hist.append(anom_err(obj.unpack(xk)["vp"].cpu().numpy()))
        print(f"  iter {len(err_hist) - 1}: in-anomaly |vp err| "
              f"{err_hist[-1]:.1f} m/s", flush=True)

    t0 = time.perf_counter()
    m0 = obj.fun(obj.x0)   # cached: minimize's first evaluation reuses it
    res = optimize.lbfgsb(obj, maxiter=n_iters, callback=track)
    seconds = time.perf_counter() - t0
    vp_out = obj.unpack(res.x)["vp"].cpu().numpy()
    err0_all = float(np.abs(vp_0 - vp_t).mean())
    err1_all = float(np.abs(vp_out - vp_t).mean())
    np.savez(os.path.join(outdir, "marmousi_scale.npz"),
             vp_true=vp_t, vp_init=vp_0, vp_out=vp_out,
             anom_mask=anom_mask, anom_err_per_iter=np.asarray(err_hist))
    metrics = {"misfit0": float(m0), "misfit1": float(res.fun),
               "nit": int(res.nit), "n_evals": int(obj.n_evals),
               "anom_err0": err_hist[0], "anom_err1": anom_err(vp_out),
               "zone_err0": zone_err(vp_0), "zone_err1": zone_err(vp_out),
               "err0_all": err0_all, "err1_all": err1_all,
               "seconds": seconds, "seconds_data": seconds_data}
    print(f"misfit {m0:.4e} -> {res.fun:.4e} after {res.nit} iterations "
          f"({obj.n_evals} evals, {seconds:.0f}s); "
          f"in-anomaly mean |vp err| {metrics['anom_err0']:.1f} -> "
          f"{metrics['anom_err1']:.1f} m/s; illuminated-zone "
          f"{metrics['zone_err0']:.1f} -> {metrics['zone_err1']:.1f} "
          f"(whole model {err0_all:.1f} -> {err1_all:.1f})", flush=True)
    return metrics


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("args", nargs="*",
                   help="outdir, n_iters, as main() takes them")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args()
    main(*a.args, device=a.device)
