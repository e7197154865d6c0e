"""Experiment drivers of the port, as a `python -m sep2023_tpu_torch` CLI.

  forward   observed-data generation + throughput report   (Main-000)
  invert    twin-experiment FWI, scipy L-BFGS-B             (Main-001..003)
  rtm       reverse-time-migration image of a layered twin  (main.cu:322+)

PyTorch counterpart of `sep2023_tpu/cli.py`.  `forward` runs both physics
(`--physics elastic|acoustic`) and `rtm` both imaging conditions (the
acoustic time-derivative one by default, the elastic zero-lag one).
`invert` is ported in its default configuration (L2 misfit on the selected
channels, one stage, the scipy optimizer, one device); each of its other
options raises NotImplementedError naming its ROADMAP item, and `bench`
comes with a later slice (ROADMAP M8).  `--device cuda` (the default) runs
the CUDA kernels and raises for work they cannot take; `--device cpu` runs
the plain PyTorch versions (and, with `--x64`, float64).  Models are
synthesized (models.py) because the reference git-ignores its
Models/*.txt grids.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from sep2023_tpu_torch import (acoustic, heads, imaging, medium, models,
                               optimize, parallel)
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch import survey_tools
from sep2023_tpu_torch.config import (SimConfig, Survey, klauder, ricker,
                                      ricker_integrated, sim_config_to_json)
from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine
from sep2023_tpu_torch.ops import signal as sg
from sep2023_tpu_torch.propagator import CHANNELS, propagate

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
        return _forward_acoustic(args, cfg, survey, med, stf)

    plan, _ = parallel._cuda_plan(cfg, survey)
    engine = "CUDA kernel" if device.type == "cuda" else "plain (CPU)"
    src = (survey.src_z + cfg.npml, survey.src_x + cfg.npml, survey.src_rxz)

    def fwd():
        data = cuda_engine.forward_cuda_plan(plan, med.lam, med.mu, med.rho,
                                             stf, *src)
        _sync(device)
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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _forward_acoustic(args, cfg, survey, med, stf):
    """`forward --physics acoustic` (the standalone CLI's acoustic branch,
    main.cu:180-197): lam = rho vp^2 through the acoustic forward kernel on
    the card, at any grid size, or its plain version on the CPU.  Writes the
    4-channel Shot_* files with a zero ett."""
    device = med.rho.device
    plan, _ = parallel._cuda_plan(cfg, survey)
    print("engine: " + (cuda_engine.plan_engine_name(plan, "acoustic")
                        if device.type == "cuda"
                        else "plain PyTorch (acoustic, CPU)"))
    lam_ac = (med.rho * med.vp ** 2).contiguous()
    t0 = time.perf_counter()
    with torch.no_grad():
        data3 = cuda_acoustic.forward_cuda_acoustic_plan(
            plan, lam_ac, med.rho.contiguous(), stf.contiguous(),
            survey.src_z + cfg.npml, survey.src_x + cfg.npml)
    _sync(device)
    t_run = time.perf_counter() - t0
    note = " (incl. kernel build)" if device.type == "cuda" else ""
    print(f"acoustic forward: {survey.n_shots} shots in {t_run:.2f}s{note}")
    if args.data_dir:
        # keep the 4-channel Shot_* format; ett is zero in acoustic mode
        d = np.zeros((survey.n_shots, 4, survey.n_rec, cfg.nt), np.float32)
        d[:, :3] = data3.cpu().numpy()
        sio.write_shots(args.data_dir, d)
        _export_config(args.data_dir, cfg, survey)
        print(f"wrote {survey.n_shots} shots to {args.data_dir}")
    return data3


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


def _rtm_acoustic(cfg, survey, vpt, vpb, rho, stf, device):
    """(image, illumination) of `rtm --physics acoustic`, summed over shots:
    observed and synthetic data through the acoustic forward, their
    difference migrated with the time-derivative condition.  On the card
    the kernels, in chunks of `auto_shot_chunk(acoustic=True)` shots; on the
    CPU the plain propagator."""
    sz, sx = survey.src_z + cfg.npml, survey.src_x + cfg.npml
    S = survey.n_shots
    if device.type != "cuda":
        geoms = parallel.survey_to_geoms(survey, cfg.npml, device=device,
                                         dtype=rho.dtype)
        ac = acoustic.AcGeom(geoms.src_z, geoms.src_x, geoms.rec_z,
                             geoms.rec_x)
        with torch.no_grad():
            obs = acoustic.propagate_acoustic_shots(cfg, rho * vpt ** 2, rho,
                                                    stf, ac)
            syn = acoustic.propagate_acoustic_shots(cfg, rho * vpb ** 2, rho,
                                                    stf, ac)
        img, ill = acoustic.rtm_image_time_shots(cfg, vpb, rho, stf, ac,
                                                 obs - syn)
        return img.sum(0), ill.sum(0)
    plan, _ = parallel._cuda_plan(cfg, survey)
    print("engine: " + cuda_engine.plan_engine_name(plan, "acoustic"))
    chunk = parallel.auto_shot_chunk(cfg, S, acoustic=True, device=device)
    lam_t, lam_b = (rho * vpt ** 2).contiguous(), (rho * vpb ** 2).contiguous()
    img = torch.zeros_like(rho)
    ill = torch.zeros_like(rho)
    with torch.no_grad():
        for a, b in parallel._chunks(S, chunk):
            src = (stf[a:b].contiguous(), sz[a:b], sx[a:b])
            obs = cuda_acoustic.forward_cuda_acoustic_plan(plan, lam_t, rho,
                                                           *src)
            syn = cuda_acoustic.forward_cuda_acoustic_plan(plan, lam_b, rho,
                                                           *src)
            im, il = cuda_acoustic.rtm_image_time_cuda_plan(
                plan, vpb, rho, *src, obs - syn, sum_shots=True)
            img += im
            ill += il
    return img, ill


def _rtm_elastic(cfg, survey, vpt, vpb, rho, stf, channels, device):
    """(image, illumination) of `rtm --physics elastic`, summed over shots:
    the zero-lag Vp condition is the Vp gradient of the L2 misfit on
    `channels`.  On the card through the elastic kernels (make_cuda_misfit,
    in chunks of `auto_shot_chunk` shots); on the CPU imaging.rtm_image a
    shot.  The illumination is an eager forward on the tensors' device."""
    vst, vsb = vpt / np.sqrt(2.2), vpb / np.sqrt(2.2)
    S = survey.n_shots
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device=device,
                                     dtype=rho.dtype)
    lam_t, mu_t = (vpt ** 2 - 2.0 * vst ** 2) * rho, vst ** 2 * rho
    if device.type == "cuda":
        plan, _ = parallel._cuda_plan(cfg, survey)
        print("engine: " + cuda_engine.plan_engine_name(plan))
        chunk = parallel.auto_shot_chunk(cfg, S, device=device)
        obs = parallel.make_forward(cfg, survey, use_kernels=True,
                                    shot_chunk=chunk, device=device)(
            lam_t.contiguous(), mu_t.contiguous(), rho, stf)
        loss = parallel.make_cuda_misfit(cfg, survey, channels=channels,
                                         shot_chunk=chunk)
        vp_ = vpb.clone().requires_grad_()
        val = loss((vp_ ** 2 - 2.0 * vsb ** 2) * rho, vsb ** 2 * rho, rho,
                   stf, obs, torch.ones(S, device=device, dtype=rho.dtype))
        (img,) = torch.autograd.grad(val, vp_)
    else:
        img = torch.zeros_like(rho)
        for i in range(S):
            g = type(geoms)(*(None if t is None else t[i] for t in geoms))
            with torch.no_grad():
                obs = propagate(cfg, lam_t, mu_t, rho, stf[i], g)
            img += imaging.rtm_image(cfg, vpb, vsb, rho, stf[i], g, obs,
                                     channels=channels)
    # per-cell source-energy illumination for the compensated product
    ill = imaging.source_illumination(
        cfg, (vpb ** 2 - 2.0 * vsb ** 2) * rho, vsb ** 2 * rho, rho, stf,
        geoms).sum(0)
    return img, ill


def cmd_rtm(args):
    """RTM command: the standalone CLI's adjoint imaging flow (main.cu:322+).

    A twin experiment for imaging: observed data from a layered true model,
    migrated with a smooth background.  --physics acoustic (the default)
    uses the time-derivative condition (image_vel_time.cu), --physics
    elastic the zero-lag Vp condition (image_vel.cu, the Vp gradient of the
    L2 misfit).  Writes the stacked image, its muted and
    illumination-compensated copies and the models to --out as .npz.
    Returns (image, illumination, row of the muted image's peak)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; --device cpu "
                           "runs the plain PyTorch version")
    if args.x64 and device.type != "cpu":
        raise NotImplementedError("--x64 runs on the CPU only: the CUDA "
                                  "kernels compute in float32")
    dtype = torch.float64 if args.x64 else torch.float32
    bad = [c for c in args.channels if c not in CHANNELS]
    if bad:
        raise SystemExit(f"unknown channel(s) {bad}; choose from {CHANNELS}")
    # classic surface acquisition (shots and receivers near z=0, reflections
    # recorded from above): the DAS bottom-row benchmark survey is an FWI
    # geometry, not a migration one
    cfg = SimConfig(nz=args.nz + 2 * args.npml, nx=args.nx + 2 * args.npml,
                    dz=args.dz, dx=args.dx, nt=args.nt, dt=args.dt,
                    f0=args.f0, npml=args.npml)
    src_x = np.arange(10, args.nx - 10, 10)
    survey = Survey(src_z=np.full(len(src_x), 2), src_x=src_x,
                    rec_z=np.full(args.nx - 20, 2),
                    rec_x=np.arange(10, args.nx - 10))
    w = torch.as_tensor(WAVELETS[args.wavelet](cfg.f0, cfg.nt, cfg.dt),
                        device=device).to(dtype)
    stf = w.expand(survey.n_shots, cfg.nt).contiguous()

    # layered true model: a reflector at 2/3 depth the smooth background
    # lacks; the image must light it back up
    z_refl = int(args.nz * 2 / 3)
    vp_t = models.layered(args.nz, args.nx, [z_refl], [3000.0, 3450.0])
    vp_bg = models.smooth(vp_t, sigma=12.0)
    pad = lambda m: torch.as_tensor(medium.pad_model_np(m, cfg.npml),
                                    device=device).to(dtype).contiguous()
    rho = pad(models.constant(args.nz, args.nx, 2400.0))
    cfg.check_stability(float(vp_t.max()))
    survey_tools.check_reach(cfg, survey, float(vp_t.max()))

    if args.physics == "acoustic":
        img, illum = _rtm_acoustic(cfg, survey, pad(vp_t), pad(vp_bg), rho,
                                   stf, device)
        condition = "time-derivative (image_vel_time.cu)"
    else:
        img, illum = _rtm_elastic(cfg, survey, pad(vp_t), pad(vp_bg), rho,
                                  stf, tuple(args.channels), device)
        condition = ("zero-lag (image_vel.cu, CUDA kernels)"
                     if device.type == "cuda" else "zero-lag (image_vel.cu)")

    compensated = imaging.illumination_compensate(img, illum).cpu().numpy()
    img, illum = img.cpu().numpy(), illum.cpu().numpy()
    assert np.isfinite(img).all()
    # acquisition mute: the raw adjoint image carries the usual near-source/
    # receiver imprint; zero the shallow rows before diagnostics (standard
    # migration practice)
    muted = img.copy()
    mute_to = cfg.npml + 2 + max(6, int(round(3000.0 / cfg.f0 / cfg.dz / 2)))
    muted[:mute_to, :] = 0.0
    zi, xi = cfg.grid.interior_slices()
    peak = int(np.abs(muted[zi, xi]).mean(axis=1).argmax())
    print(f"rtm ({args.physics}, {condition}): {survey.n_shots} shots, "
          f"reflector at z={z_refl}, muted-image peak at z={peak}")
    out = args.out or "rtm_image.npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, image=img, image_muted=muted, illumination=illum,
             image_compensated=compensated, vp_true=vp_t,
             vp_background=vp_bg, z_reflector=z_refl)
    print(f"wrote {out}")
    return img, illum, peak


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

    r = sub.add_parser("rtm", parents=[common])
    r.add_argument("--physics", default="acoustic",
                   choices=("elastic", "acoustic"),
                   help="acoustic = the reference's main.cu RTM path with "
                        "the image_vel_time.cu condition; elastic = zero-lag "
                        "Vp condition via the FWI gradient machinery")
    r.add_argument("--channels", nargs="+", default=["pr", "vx", "vz"],
                   help="elastic imaging channels")
    r.add_argument("--out", default="",
                   help="output .npz path (default rtm_image.npz)")
    r.add_argument("--x64", action="store_true",
                   help="float64 (with --device cpu only)")
    r.set_defaults(fn=cmd_rtm)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
