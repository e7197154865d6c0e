"""Overthrust-style spline-fiber DAS FWI demo on the PyTorch/CUDA port, the
counterpart of `examples/overthrust_das.py`.

Mirrors the reference's second fiber-geometry flow
(`DAS_Waveform_Modeling/matlab/DAS_Geometry_Overthrust.m:28-50`): a cable
laid as a spline through control points draped over a structured
(overthrust) model, resampled to equal arc length, with Frenet-tangent
directional sensitivity weights, then inverted end to end with the
directional 'weighted' strain channel.  The cable runs as point receivers
(`cuda_engine.FiberSurvey` with weights) through `parallel.make_cuda_misfit`
and scipy L-BFGS-B: the CUDA kernels on `--device cuda`, their plain
PyTorch versions on `--device cpu`.

Run:  python examples/overthrust_das_torch.py [outdir] [n_iters] [nt]
          [src_step] [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from sep2023_tpu_torch import das, models, optimize, parallel
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.medium import pad_model, pad_model_np
from sep2023_tpu_torch.ops import cuda_engine

NPML = 16
NZ, NX, DH = 60, 100, 10.0
# spline control points of the cable over the structure (x, z, y), m
CONTROL_POINTS = np.array([[150.0, 420.0, 0.0], [350.0, 330.0, 0.0],
                           [550.0, 430.0, 0.0], [750.0, 360.0, 0.0],
                           [900.0, 420.0, 0.0]])


def problem(nt=501, src_step=10):
    """(cfg, survey, das_w, vp_true, vp_init, cable): the folded and
    thrusted layers (DAS_Geometry_Overthrust.m's target structure,
    synthesized since the reference git-ignores its Models/ grids), the
    spline cable's receivers and weights, surface shots every src_step
    cells."""
    cfg = SimConfig(nz=NZ + 2 * NPML, nx=NX + 2 * NPML, dz=DH, dx=DH,
                    nt=int(nt), dt=0.001, f0=15.0, npml=NPML,
                    das_channel="weighted")
    vp_true = models.overthrust_vp(NZ, NX)
    vp_init = models.smooth(vp_true, 10.0)
    cfg.check_stability(float(vp_true.max()))
    cable = das.spline_fiber(CONTROL_POINTS)
    rec_z, rec_x, das_w = das.cable_to_receivers(cable, cfg.dx, cfg.dz)
    src_x = np.arange(10, NX - 10, int(src_step))
    survey = Survey(src_z=np.full(len(src_x), 1), src_x=src_x, rec_z=rec_z,
                    rec_x=rec_x)
    return cfg, survey, das_w, vp_true, vp_init, cable


def objective(cfg, survey, das_w, vp_true, vp_init, device):
    """The example's ScipyObjective: the L2 misfit of the weighted ett
    channel through make_cuda_misfit on the cable's points, from observed
    data of the true model through make_forward on the same plan; vp is the
    physical grid, edge-padded inside the loss."""
    npml = cfg.npml
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(
        torch.float32)
    rho = t(pad_model_np(models.constant(NZ, NX, 2300.0), npml))
    stf = t(ricker(cfg.f0, cfg.nt, cfg.dt)).expand(
        survey.n_shots, cfg.nt).contiguous()

    def lame(vp_pad):
        vs_pad = vp_pad / np.sqrt(3.0)
        return (vp_pad ** 2 - 2 * vs_pad ** 2) * rho, vs_pad ** 2 * rho, rho

    fwd = parallel.make_forward(cfg, survey, use_kernels=True, device=device,
                                das_w=das_w)
    obs = fwd(*(a.contiguous() for a in lame(t(pad_model_np(vp_true,
                                                             npml)))), stf)
    data_loss = parallel.make_cuda_misfit(cfg, survey, channels=("ett",),
                                          das_w=das_w)
    w = torch.ones(survey.n_shots, device=device)

    def loss(params, stf_, obs_):
        return data_loss(*lame(pad_model(params["vp"], npml)), stf_, obs_, w)

    return optimize.ScipyObjective(loss, {"vp": vp_init}, aux=(stf, obs),
                                   device=device)


def main(outdir="scratch/overthrust_das", n_iters=10, nt=501, src_step=10,
         device="cuda"):
    """Defaults are the demo run; smaller nt/n_iters/denser src_step let
    the suite smoke-test the script on the CPU.  Returns the metrics dict
    it prints, with the evaluations and the seconds in L-BFGS-B."""
    os.makedirs(outdir, exist_ok=True)
    n_iters = int(n_iters)
    device = torch.device(device)
    cfg, survey, das_w, vp_true, vp_init, cable = problem(nt, src_step)
    npml = cfg.npml
    rec_z, rec_x = survey.rec_z, survey.rec_x
    print(f"cable: {len(rec_z)} channels, depth rows "
          f"{rec_z.min()}..{rec_z.max()}")
    plan = cuda_engine.plan_fast_path(cfg, rec_z + npml, rec_x + npml,
                                      das_w=das_w)
    assert plan is not None, "cable does not fit a plan"
    print(f"plan: {type(plan.rs).__name__}; engine: "
          + (cuda_engine.plan_engine_name(plan) if device.type == "cuda"
             else "plain PyTorch (CPU)"))
    print("generating observed DAS data (true model) ...")
    obj = objective(cfg, survey, das_w, vp_true, vp_init, device)
    print("inverting vp from the DAS 'ett' channel ...")
    t0 = time.perf_counter()
    f0 = obj.fun(obj.x0)   # cached: minimize's first evaluation reuses it
    res = optimize.lbfgsb(obj, maxiter=n_iters)
    seconds = time.perf_counter() - t0
    vp_out = obj.unpack(res.x)["vp"].cpu().numpy()
    np.savez(os.path.join(outdir, "overthrust_das.npz"),
             vp_true=vp_true, vp_init=vp_init, vp_out=vp_out,
             rec_z=rec_z, rec_x=rec_x, das_w=das_w, cable=cable)
    # report recovery where the transmission geometry illuminates: between
    # the surface sources and the fiber depth, inside the source spread
    zone = (slice(2, int(rec_z.max()) + 2), slice(10, NX - 10))
    zerr0 = float(np.abs(vp_init - vp_true)[zone].mean())
    zerr1 = float(np.abs(vp_out - vp_true)[zone].mean())
    err0 = float(np.abs(vp_init - vp_true).mean())
    err1 = float(np.abs(vp_out - vp_true).mean())
    metrics = {"misfit0": float(f0), "misfit1": float(res.fun),
               "nit": int(res.nit), "zone_err0": zerr0, "zone_err1": zerr1,
               "err0_all": err0, "err1_all": err1,
               "n_evals": obj.n_evals, "seconds": seconds}
    print(f"misfit {f0:.4e} -> {res.fun:.4e} after {res.nit} iterations "
          f"({obj.n_evals} evaluations, {seconds:.1f} s); illuminated-zone "
          f"mean |vp err| {zerr0:.1f} -> {zerr1:.1f} m/s (whole model "
          f"{err0:.1f} -> {err1:.1f})")
    print(f"wrote {outdir}/overthrust_das.npz")
    return metrics


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("args", nargs="*",
                   help="outdir, n_iters, nt, src_step, as main() takes them")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args()
    main(*a.args, device=a.device)
