"""Experiment drivers of the port, as a `python -m sep2023_tpu_torch` CLI.

  forward   observed-data generation + throughput report   (Main-000)
  invert    twin-experiment FWI, scipy L-BFGS-B             (Main-001..003)

PyTorch counterpart of `sep2023_tpu/cli.py`.  `invert` is ported in its
default configuration (L2 misfit on the selected channels, one stage, the
scipy optimizer, one device); each of its other options raises
NotImplementedError naming its ROADMAP item, and `rtm` and `bench` come
with later slices (ROADMAP M8, M9).  `--device cuda` (the default) runs the
CUDA kernels and raises for work they cannot take; `--device cpu` runs the
plain PyTorch versions (and, with `--x64`, float64).  Models are
synthesized (models.py) because the reference git-ignores its
Models/*.txt grids.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from sep2023_tpu_torch import heads, medium, models, optimize, parallel
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch import survey_tools
from sep2023_tpu_torch.config import (SimConfig, Survey, klauder, ricker,
                                      ricker_integrated, sim_config_to_json)
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.ops import signal as sg
from sep2023_tpu_torch.propagator import CHANNELS

WAVELETS = {"ricker": ricker, "ricker_int": ricker_integrated,
            "klauder": klauder}


def benchmark_problem(nz=101, nx=201, dz=20.0, dx=20.0, nt=1501, dt=0.002,
                      f0=10.0, npml=32, wavelet="ricker", *, device,
                      dtype=torch.float32):
    """The reference GPU benchmark workload (Main-000/001: 101x201 grid,
    19 shots at z=1, 181 receivers at z=95, nt=1501).

    For non-default nz the receiver row scales PROPORTIONALLY (z = 95/101 of
    the grid) so sweeps over grid size keep a geometrically comparable
    survey."""
    cfg = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=dz, dx=dx,
                    nt=nt, dt=dt, f0=f0, npml=npml)
    src_x = np.arange(10, nx - 10, 10)
    rec_z = min(int(round(95 * nz / 101)), nz - 6)
    if nz != 101:
        print(f"note: receiver row scaled to z={rec_z} for nz={nz} "
              f"(reference survey is z=95 of 101)")
    survey = Survey(src_z=np.ones(len(src_x)), src_x=src_x,
                    rec_z=np.full(nx - 20, rec_z),
                    rec_x=np.arange(10, nx - 10))
    geoms = parallel.survey_to_geoms(survey, npml, device=device,
                                     dtype=dtype)
    w = torch.as_tensor(WAVELETS[wavelet](f0, nt, dt), device=device
                        ).to(dtype)
    stf = w.expand(survey.n_shots, nt)
    return cfg, survey, geoms, stf


def cmd_forward(args):
    device = torch.device(args.device)
    dtype = torch.float32
    cfg, survey, geoms, stf = benchmark_problem(
        nz=args.nz, nx=args.nx, dz=args.dz, dx=args.dx, nt=args.nt,
        dt=args.dt, f0=args.f0, npml=args.npml, wavelet=args.wavelet,
        device=device, dtype=dtype)
    # wavelet end-taper, matching the reference's upload path
    # (cuda_window(..., 0.001, ...), Src_Rec.cu:130-142)
    stf = stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=device,
                                dtype=dtype)
    vp, vs, rho = models.anomaly_vp_vs_rho(args.nz, args.nx)
    pad = lambda a: torch.as_tensor(medium.pad_model_np(a, cfg.npml),
                                    device=device).to(dtype)
    med = medium.Medium(pad(vp), pad(vs), pad(rho))
    cfg.check_stability(float(vp.max()))
    survey_tools.check_reach(cfg, survey, float(vp.max()))
    medium.check_lambda(med.lam)  # Model.cu:37-40

    if args.physics == "acoustic":
        raise NotImplementedError(
            "acoustic forward is not ported yet (ROADMAP M9, kernel K5)")

    plan, _ = parallel._cuda_plan(cfg, survey)
    engine = "CUDA kernel" if device.type == "cuda" else "plain (CPU)"
    src = (survey.src_z + cfg.npml, survey.src_x + cfg.npml, survey.src_rxz)

    def fwd():
        data = cuda_engine.forward_cuda_plan(plan, med.lam, med.mu, med.rho,
                                             stf, *src)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return data

    t0 = time.perf_counter()
    fwd()  # warm-up: builds the kernel library on first use
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = fwd()
    t_run = time.perf_counter() - t0

    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * survey.n_shots
    print(f"forward ({engine}): {survey.n_shots} shots, grid "
          f"{cfg.nz}x{cfg.nx}, nt={cfg.nt}; warm-up {t_warm:.1f}s, "
          f"run {t_run:.3f}s, {cells / t_run / 1e9:.2f} GCell/s")
    if args.data_dir:
        sio.write_shots(args.data_dir, data.cpu().numpy())
        _export_config(args.data_dir, cfg, survey)
        print(f"wrote {survey.n_shots} shots to {args.data_dir}")
    return data


def _export_config(data_dir, cfg, survey):
    """Reference-schema para_file.json + survey_file.json next to the Shot
    binaries (fwi_utils.py:46-124's two-file side channel), so the data dir
    is directly consumable by tooling built for the reference."""
    sj = os.path.join(data_dir, "survey_file.json")
    survey.to_json(sj)
    sim_config_to_json(cfg, os.path.join(data_dir, "para_file.json"),
                       sj, data_dir_name=data_dir)


def build_stage_loss(cfg, survey, geoms, *, use_kernels, shot_chunk,
                     channels):
    """The loss of one stage, data_loss(lam, mu, rho, stf, obs, weights):
    the CUDA kernels' (`make_cuda_misfit`) or the plain propagator's
    (`make_local_misfit`), L2 on `channels`.  The JAX package's other
    misfits, conditioning and sharded losses are ROADMAP M3 and M10."""
    if use_kernels:
        return parallel.make_cuda_misfit(cfg, survey, channels=tuple(channels),
                                         shot_chunk=shot_chunk)
    base = parallel.make_local_misfit(cfg, channels=tuple(channels),
                                      shot_chunk=shot_chunk)
    return lambda lam, mu, rho, stf, obs, w: base(lam, mu, rho, stf, geoms,
                                                  obs, w)


def _reject_unported(args):
    """Options of the JAX package's `invert` that the port does not have
    yet raise, naming their ROADMAP item."""
    unported = [
        (args.misfit != "l2", "--misfit xcorr", "M3"),
        (args.energy_weights, "--energy-weights", "M3"),
        (args.multiscale or args.bands, "--multiscale/--bands", "M3"),
        (args.win is not None, "--win", "M3"),
        (args.src_update, "--src-update", "M3"),
        (args.save_mat, "--save-mat", "M5"),
        (args.invert_stf, "--invert-stf", "M7"),
        (args.resume, "--resume", "M7"),
        (args.para_json, "--para-json", "M7"),
        (args.survey_json, "--survey-json", "M7"),
        (args.scratch_dir, "--scratch-dir", "M7"),
        (args.n_devices > 1, "--n-devices", "M10"),
        (args.optimizer == "ondevice", "--optimizer ondevice", "M11"),
    ]
    for given, flag, item in unported:
        if given:
            raise NotImplementedError(
                f"invert {flag} is not ported yet (ROADMAP {item})")


def cmd_invert(args):
    """Twin-experiment FWI in the default configuration: observed data from
    the true model, then scipy L-BFGS-B from the smoothed initial model,
    each evaluation one gradient (forward with strips, L2 misfit, adjoint,
    the head's chain rule).  Writes Results/loss.txt and model/gradient
    snapshots under --exp-name.  Returns a summary dict (evaluations, final
    misfit, seconds of the optimizer, shots per gradient chunk)."""
    _reject_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; --device cpu "
                           "runs the plain PyTorch version")
    if args.x64 and device.type != "cpu":
        raise NotImplementedError("--x64 runs on the CPU only: the CUDA "
                                  "kernels compute in float32")
    dtype = torch.float64 if args.x64 else torch.float32
    cfg, survey, geoms, stf = benchmark_problem(
        nz=args.nz, nx=args.nx, dz=args.dz, dx=args.dx, nt=args.nt,
        dt=args.dt, f0=args.f0, npml=args.npml, wavelet=args.wavelet,
        device=device, dtype=dtype)
    # taper the wavelet ends exactly as the reference does on upload
    # (cuda_window(..., 0.001, ...), Src_Rec.cu:130-142)
    stf = (stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=device,
                                 dtype=dtype)).contiguous()
    grid = cfg.grid
    os.makedirs(args.exp_name, exist_ok=True)

    true_params, init_params, bounds, invert_names = \
        models.twin_experiment_setup(args.head, args.nz, args.nx,
                                     model=args.model)
    head = heads.HEADS[args.head](grid, init_params,
                                  mask=heads.default_mask(grid, 4),
                                  bounds=bounds)

    if args.shot_chunk < 0:
        # shots in flight per gradient so that the boundary strips and the
        # state planes fit
        isz = 8 if args.x64 else 4
        args.shot_chunk = parallel.auto_shot_chunk(
            cfg, survey.n_shots, itemsize=isz, device=device)
        if args.shot_chunk:
            gb = (parallel.strip_bytes_per_shot(cfg, itemsize=isz)
                  + parallel.state_bytes_per_shot(cfg, itemsize=isz)) / 2 ** 30
            print(f"shot-chunk auto: {args.shot_chunk} shots/chunk "
                  f"(~{gb:.2f} GB strips and planes/shot)")
    # a CUDA device runs the kernels (float32, any grid size) and raises
    # for anything else; the plain propagator runs on the CPU only
    use_kernels = device.type == "cuda"
    if use_kernels:
        plan, _ = parallel._cuda_plan(cfg, survey)
    print("engine: " + (cuda_engine.plan_engine_name(plan) if use_kernels
                        else "plain PyTorch (CPU)"))
    fwd = parallel.make_forward(cfg, survey, use_kernels=use_kernels,
                                shot_chunk=args.shot_chunk, device=device,
                                dtype=dtype)

    def tensors(params):
        return {k: torch.as_tensor(np.asarray(v)).to(device, dtype)
                for k, v in params.items()}

    # --- observed data (twin experiment) --------------------------------
    lam_t, mu_t, rho_t = head.apply(tensors(true_params))
    vp_max_t = float(torch.sqrt((lam_t + 2 * mu_t) / rho_t).max())
    cfg.check_stability(vp_max_t)
    survey_tools.check_reach(cfg, survey, vp_max_t)
    medium.check_lambda(lam_t)  # Model.cu:37-40
    init_t = tensors(init_params)
    medium.check_lambda(head.apply(init_t)[0])
    data_dir = args.data_dir or os.path.join(args.exp_name, "Data")
    if (not args.generate_data
            and os.path.exists(os.path.join(data_dir, "Shot_pr0.bin"))):
        # the reference's two-invocation workflow: observed data written by
        # a prior --generate_data run (or by the reference engine itself)
        print(f"loading observed data from {data_dir} ...")
        obs = torch.as_tensor(sio.read_shots_survey(data_dir, survey,
                                                    cfg.nt)).to(device, dtype)
    else:
        print("generating observed data ...")
        obs = fwd(lam_t, mu_t, rho_t, stf).to(dtype)
    if args.generate_data:
        sio.write_shots_survey(data_dir, obs.cpu().numpy(), survey)
        _export_config(data_dir, cfg, survey)
        print(f"data written to {data_dir}; exiting (--generate_data)")
        return None

    bad = [c for c in args.channels if c not in CHANNELS]
    if bad:
        raise SystemExit(f"unknown channel(s) {bad}; choose from {CHANNELS}")
    weights = torch.ones(survey.n_shots, device=device, dtype=dtype)
    data_loss = build_stage_loss(cfg, survey, geoms, use_kernels=use_kernels,
                                 shot_chunk=args.shot_chunk,
                                 channels=args.channels)

    def loss(params, stf_, obs_):
        lam, mu, rho = head.apply({**init_t, **params})
        return data_loss(lam, mu, rho, stf_, obs_, weights)

    start_params = {k: init_params[k] for k in invert_names}
    obj = optimize.ScipyObjective(
        loss, start_params,
        bounds={k: bounds[k] for k in invert_names} if bounds else None,
        aux=(stf, obs), device=device, dtype=dtype)
    logger = optimize.InversionLogger(os.path.join(args.exp_name, "Results"),
                                      obj)
    print(f"L-BFGS-B: {args.niter} iterations, head={args.head}")
    t0 = time.perf_counter()
    res = optimize.lbfgsb(obj, maxiter=args.niter, callback=logger)
    seconds = time.perf_counter() - t0
    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * survey.n_shots
    per_eval = seconds / max(obj.n_evals, 1)
    print(f"stage misfit {res.fun:.6e} after {res.nit} iterations "
          f"({obj.n_evals} evaluations, {per_eval:.3f} s each, "
          f"{cells / per_eval / 1e9:.2f} GCell/s gradient)")
    return {"n_evals": obj.n_evals, "nit": int(res.nit),
            "misfit": float(res.fun), "seconds": seconds,
            "shot_chunk": args.shot_chunk}


def main(argv=None):
    p = argparse.ArgumentParser(prog="sep2023_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--nz", type=int, default=101)
    common.add_argument("--nx", type=int, default=201)
    common.add_argument("--dz", type=float, default=20.0)
    common.add_argument("--dx", type=float, default=20.0)
    common.add_argument("--nt", type=int, default=1501)
    common.add_argument("--dt", type=float, default=0.002)
    common.add_argument("--f0", type=float, default=10.0)
    common.add_argument("--npml", type=int, default=32)
    common.add_argument("--wavelet", default="ricker",
                        choices=("ricker", "ricker_int", "klauder"))
    common.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda runs the CUDA kernel; cpu runs its plain "
                             "PyTorch version")

    f = sub.add_parser("forward", parents=[common])
    f.add_argument("--data-dir", default="")
    f.add_argument("--physics", default="elastic",
                   choices=("elastic", "acoustic"))
    f.set_defaults(fn=cmd_forward)

    i = sub.add_parser("invert", parents=[common])
    i.add_argument("--head", default="vp_vs_rho", choices=sorted(heads.HEADS))
    i.add_argument("--data-dir", default="",
                   help="observed-data directory (Shot_*.bin); generated "
                        "in-process when absent")
    i.add_argument("--exp-name", default="scratch/exp")
    i.add_argument("--niter", type=int, default=20)
    i.add_argument("--channels", nargs="+", default=["ett"])
    i.add_argument("--generate_data", action="store_true")
    i.add_argument("--x64", action="store_true",
                   help="float64 (with --device cpu only)")
    i.add_argument("--model", default="anomaly", choices=("anomaly", "rock"),
                   help="'rock' needs rock_physics (ROADMAP M4)")
    i.add_argument("--shot-chunk", type=int, default=-1,
                   help="shots per gradient chunk (bounds boundary-strip "
                        "memory; -1 = auto-size from the grid so the "
                        "strips fit device memory, 0 = unchunked)")
    # options of the JAX package's invert that are not ported yet: each
    # raises NotImplementedError naming its ROADMAP item
    i.add_argument("--misfit", default="l2", choices=("l2", "xcorr"))
    i.add_argument("--energy-weights", action="store_true")
    i.add_argument("--multiscale", action="store_true")
    i.add_argument("--bands", default="")
    i.add_argument("--win", default=None)
    i.add_argument("--src-update", action="store_true")
    i.add_argument("--invert-stf", action="store_true")
    i.add_argument("--resume", action="store_true")
    i.add_argument("--para-json", default="")
    i.add_argument("--survey-json", default="")
    i.add_argument("--scratch-dir", default="")
    i.add_argument("--save-mat", action="store_true")
    i.add_argument("--optimizer", default="scipy",
                   choices=("scipy", "ondevice"))
    i.add_argument("--n-devices", type=int, default=0,
                   help="1 device only (shot sharding is ROADMAP M10)")
    i.set_defaults(fn=cmd_invert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
