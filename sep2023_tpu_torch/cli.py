"""Experiment drivers of the port, as a `python -m sep2023_tpu_torch` CLI.

  forward   observed-data generation + throughput report   (Main-000)
  invert    twin-experiment FWI with any parameterization   (Main-001..005)
              --head vp_vs_rho   -> Main-001
              --head lame_rho    -> Main-002
              --head ip_is_rho   -> Main-003
              --head rock_gassmann -> Main-004 (--head rock_vrh: 00x)
              --model rock (a velocity head) -> Main-005 (NO-PCS)
  rtm       reverse-time-migration image of a layered twin  (main.cu:322+)
  bench     the benchmark: bench_torch.py at the repository root, bench.py's
            sections on the CUDA kernels, one JSON line (on the card only)

PyTorch counterpart of `sep2023_tpu/cli.py`.  `forward` runs both physics
(`--physics elastic|acoustic`) and `rtm` both imaging conditions (the
acoustic time-derivative one by default, the elastic zero-lag one).
`invert` takes every option of the JAX package's: the conditioned misfits,
the multiscale stage loop with the per-stage source update, the joint
source inversion, resume, the reference's JSON and scratch files, the
on-device L-BFGS (`--optimizer ondevice`), and the shots sharded over
several devices (`--n-devices`: every CUDA device by default, as the JAX
CLI shards over every visible device; k CPU shards with --device cpu).
`bench` runs on the card only: its sizes are the JAX bench's, where the
plain versions take hours.

Engines (`resolve_engine`), as the JAX CLI picks its Pallas kernels or its
XLA engine, from the survey's plan (`parallel.try_plan`) before anything
runs.  The kernel route is the CUDA kernels on --device cuda and their
plain versions on --device cpu (the JAX package runs its Pallas kernels in
interpret mode there); the plain PyTorch version, the XLA engine's
counterpart, runs on whatever device --device names (`cuda`, the default,
or `cpu`):
  `invert --engine xla`    the plain version
  `invert --engine pallas` the kernel route; float64 (--x64) and a survey
                           no plan takes raise and name --engine xla
  `--engine auto`          the kernel route in float32 on --device cuda,
                           where a survey no plan takes raises and names
                           --engine xla; the plain version otherwise
                           (--device cpu, --x64)
The JAX CLI drops to its XLA engine where no plan takes the survey; the
port runs the plain version on the card only when asked (--engine xla).
`rtm` takes auto, `forward` the kernels on the card and their plain
versions with --device cpu.  The `engine:` line names what runs: `CUDA
kernels (...), receiver row` on the card, `plain versions of the CUDA
kernels (cpu, float32), receiver row` on the CPU, `plain PyTorch (cuda:0,
float32)` for the plain version.  Models are synthesized (models.py)
because the reference git-ignores its Models/*.txt grids.
"""
from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import time

import numpy as np
import torch

from sep2023_tpu_torch import (acoustic, heads, imaging, medium, models,
                               optimize, parallel, spans)
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch import survey_tools
from sep2023_tpu_torch.config import (SimConfig, Survey, klauder, ricker,
                                      ricker_integrated, sim_config_from_json,
                                      sim_config_to_json)
from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine
from sep2023_tpu_torch.ops import misfit as mf
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
                     channels, mesh=None, objective="l2",
                     filter_corners=None, per_trace=False,
                     dynamic_bandpass=False, window=None):
    """The loss of one stage, for every (engine x sharding x misfit x
    conditioning) combination: data_loss(lam, mu, rho, stf, obs, weights,
    *trace_aux), the CUDA kernels' (`make_cuda_misfit`) or the plain
    propagator's (`make_local_misfit`), or with a mesh their sharded forms
    (`make_cuda_sharded_misfit`, `make_sharded_misfit`; the survey and
    geoms then padded to the mesh).  Plain L2 on `channels` unless an
    objective, a band-pass (static `filter_corners`, or with
    dynamic_bandpass a per-shot (S, nfreq) response as the last trace_aux),
    a scalar `window` or per_trace conditioning ((S, R) win_start, win_end
    and trace weights as the first three trace_aux, superseding `window`,
    as the reference's per-trace entries override if_win,
    Src_Rec.cu:145-200) asks for `misfit.make_preprocessed_l2`."""
    if (per_trace or objective != "l2" or filter_corners is not None
            or dynamic_bandpass or window is not None):
        fn = mf.make_preprocessed_l2(
            channels=tuple(channels), dt=cfg.dt,
            filter_corners=filter_corners, per_trace=per_trace,
            objective=objective, dynamic_bandpass=dynamic_bandpass,
            window=window)
    else:
        fn = None
    n_aux = 3 * per_trace + dynamic_bandpass
    if mesh is not None and use_kernels:
        return parallel.make_cuda_sharded_misfit(
            cfg, survey, mesh, channels=tuple(channels), misfit_fn=fn,
            n_trace_aux=n_aux, shot_chunk=shot_chunk)
    if use_kernels:
        return parallel.make_cuda_misfit(cfg, survey, channels=tuple(channels),
                                         shot_chunk=shot_chunk, misfit_fn=fn)
    if mesh is not None:
        base = parallel.make_sharded_misfit(
            cfg, mesh, channels=tuple(channels), misfit_fn=fn,
            n_trace_aux=n_aux, shot_chunk=shot_chunk)
    else:
        base = parallel.make_local_misfit(cfg, channels=tuple(channels),
                                          shot_chunk=shot_chunk, misfit_fn=fn)
    return lambda lam, mu, rho, stf, obs, w, *aux: base(
        lam, mu, rho, stf, geoms, obs, w, *aux)


def resolve_engine(engine: str, device, dtype, plan) -> bool:
    """Whether a run takes the kernel route (True) or the plain PyTorch
    version on `device` (False), chosen from the survey's plan before
    anything runs: the JAX CLI's choice between its Pallas kernels and its
    XLA engine (sep2023_tpu/cli.py:338-343), where the plain version is the
    XLA engine's counterpart and runs on the device asked for, the card
    included.  engine: --engine (auto, xla, pallas); plan: the survey's
    FastPlan, None when a receiver lies outside the range the kernels
    record (`parallel.try_plan`).  The kernel route is the CUDA kernels on
    a CUDA device and their plain versions on the CPU, as the JAX package
    runs its Pallas kernels in interpret mode there.  xla takes the plain
    version; auto the kernel route for float32 on a CUDA device, else the
    plain version; pallas the kernel route on either device.  Raises
    ValueError where the kernel route is asked for and cannot run: pallas
    in float64 (the kernels compute float32), and a survey no plan takes
    under pallas, or under auto in float32 on a CUDA device.  The JAX CLI
    drops to XLA there; the port runs the plain version only when asked,
    and names --engine xla."""
    device = torch.device(device)
    if engine == "xla":
        return False
    if engine == "pallas" and dtype != torch.float32:
        raise ValueError("--engine pallas computes in float32: --x64 runs "
                         "on --engine xla")
    if engine == "auto" and (device.type != "cuda" or dtype != torch.float32):
        return False
    if plan is None:
        raise ValueError("no plan of the CUDA kernels takes the survey's "
                         "receivers: --engine xla runs it on the plain "
                         f"PyTorch version on --device {device.type}")
    return True


def plain_engine_name(device, dtype) -> str:
    """The plain engine's `engine:` line: plain PyTorch (cuda:0, float64)."""
    return f"plain PyTorch ({device}, {str(dtype).removeprefix('torch.')})"


def host_line(records) -> str | None:
    """The host time of the evaluations among span records, per
    evaluation (`spans.per_evaluation`): scipy's L-BFGS-B between them
    (left out where no scipy ran), the unpack of x, the head, the kernel
    library's calls that enqueue the launches, the wait for the card and
    the copies back; and the KiB copied each way.  None without an
    evaluation."""
    p = spans.per_evaluation(records)
    if p is None:
        return None
    parts = [f"{k} {p[k]:.3f} ms" for k in ("scipy", "unpack", "head",
                                             "enqueue", "wait")
             if p[k] is not None]
    return (f"host per evaluation: {', '.join(parts)}; copied "
            f"{p['h2d_kib']:.1f} KiB to the device, {p['d2h_kib']:.1f} KiB "
            "to the host")


def shot_weights(survey, *, device, dtype):
    """The per-shot misfit factors of `invert`: a shot's src_weight
    multiplies its residual (utilities.cu:838), so the misfit scales with
    its square (sep2023_tpu/cli.py:411-417); ones when the survey has no
    weights."""
    if survey.src_weights is None:
        return torch.ones(survey.n_shots, device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(survey.src_weights)).to(
        device, dtype) ** 2


def _load_para_json(args):
    """Run straight off a reference-schema para_file.json
    (Parameter.cpp:17-178): its grid/time/PML settings, its survey_fname and
    data_dir_name unless given on the command line, its `filter` corners as
    one band-passed stage (Parameter.cpp:139-177) unless --bands is given,
    and its if_win window unless --win is given."""
    with open(args.para_json) as fp:
        pd = json.load(fp)
    pcfg = sim_config_from_json(args.para_json)
    args.nz = pcfg.nz - 2 * pcfg.npml
    args.nx = pcfg.nx - 2 * pcfg.npml
    args.dz, args.dx = pcfg.dz, pcfg.dx
    args.nt, args.dt, args.f0 = pcfg.nt, pcfg.dt, pcfg.f0
    args.npml = pcfg.npml
    if not args.survey_json and pd.get("survey_fname"):
        args.survey_json = pd["survey_fname"]
    if not args.data_dir and pd.get("data_dir_name"):
        args.data_dir = pd["data_dir_name"]
    if not args.bands and pd.get("filter"):
        args.bands = ",".join(str(float(v)) for v in pd["filter"])
        print(f"band-pass from para filter: {args.bands}")
    if args.win is None and pd.get("if_win") and "win_start" in pd:
        args.win = f"{pd['win_start']},{pd['win_end']}"
    print(f"para loaded from {args.para_json}: grid {pcfg.nz}x{pcfg.nx} "
          f"(padded), nt={pcfg.nt}, dt={pcfg.dt}, npml={pcfg.npml}")


def _stages(args):
    """The band-pass corners of each stage: one quadruple a ';'-separated
    --bands entry (Main-001:46-51), the classic 2.5..7.5 Hz ramp for
    --multiscale alone, else one unfiltered stage [None]."""
    if args.bands:
        try:
            stages = [tuple(float(v) for v in b.split(","))
                      for b in args.bands.split(";") if b.strip()]
        except ValueError:
            raise SystemExit(f"--bands must be 'f0,f1,f2,f3;...', "
                             f"got {args.bands!r}")
        if not stages or any(len(b) != 4 for b in stages):
            raise SystemExit("each --bands stage needs exactly 4 corner "
                             "frequencies f0,f1,f2,f3 (Main-001:46-51)")
        return stages
    if args.multiscale:
        return [(0.0, 1e-4, 2.0, hf) for hf in (2.5, 3.5, 4.5, 5.5, 6.5, 7.5)]
    return [None]


def _window(args):
    """(start, end) samples of --win, or None."""
    if not args.win:
        return None
    try:
        w0, w1 = (float(v) for v in args.win.split(","))
    except ValueError:
        raise SystemExit(f"--win must be 'start,end' samples, "
                         f"got {args.win!r}")
    print(f"scalar taper window [{w0:g}, {w1:g}] samples (if_win, "
          "utilities.cu:790-884)")
    return w0, w1


def cmd_invert(args):
    """Twin-experiment FWI (Main-001..005): observed data from the true
    model (or read from --data-dir), then scipy L-BFGS-B from the smoothed
    initial model, each evaluation one gradient (forward with strips, the
    misfit, adjoint, the head's chain rule), in one stage or in the
    band-pass stages of --bands/--multiscale.  Writes Results/loss.txt and
    model/gradient snapshots under --exp-name.  Returns a summary dict
    (evaluations and iterations of all stages, final misfit, seconds in
    the optimizer, shots per gradient chunk, stages, forwards of
    --src-update), or None after --generate_data.  --optimizer ondevice
    takes the on-device L-BFGS (optimize.lbfgs_on_device) in place of
    scipy's, with the JAX package's loss.txt lines and one model snapshot a
    stage.  --n-devices shards the shots (`parallel.shot_mesh`), padded
    with zero-weight replicas of the last shot to a multiple of the mesh;
    the files it writes hold the real shots only."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; --device cpu "
                           "runs the plain PyTorch version")
    dtype = torch.float64 if args.x64 else torch.float32
    if args.para_json:
        _load_para_json(args)
    cfg, survey, geoms, stf = benchmark_problem(
        nz=args.nz, nx=args.nx, dz=args.dz, dx=args.dx, nt=args.nt,
        dt=args.dt, f0=args.f0, npml=args.npml, wavelet=args.wavelet,
        device=device, dtype=dtype)
    if args.survey_json:
        # acquisition (with per-trace windows/weights and src_weights) from
        # a reference-schema survey_file.json (Src_Rec.cu:20-282)
        survey = Survey.from_json(args.survey_json)
        geoms = parallel.survey_to_geoms(survey, cfg.npml, device=device,
                                         dtype=dtype)
        w = torch.as_tensor(WAVELETS[args.wavelet](cfg.f0, cfg.nt, cfg.dt),
                            device=device).to(dtype)
        stf = w.expand(survey.n_shots, cfg.nt)
        print(f"survey loaded from {args.survey_json}: "
              f"{survey.n_shots} shots, {survey.n_rec} receivers")
    # taper the wavelet ends exactly as the reference does on upload
    # (cuda_window(..., 0.001, ...), Src_Rec.cu:130-142)
    stf = (stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, device=device,
                                 dtype=dtype)).contiguous()
    window = _window(args)
    grid = cfg.grid
    os.makedirs(args.exp_name, exist_ok=True)

    true_params, init_params, bounds, invert_names = \
        models.twin_experiment_setup(args.head, args.nz, args.nx,
                                     model=args.model, dtype=dtype)
    head = heads.HEADS[args.head](grid, init_params,
                                  mask=heads.default_mask(grid, 4),
                                  bounds=bounds)

    # the mesh is resolved before the data are made, so that the twin data
    # and the --src-update synthetics run on it as the stage losses do
    n_shots = survey.n_shots
    mesh = parallel.shot_mesh(args.n_devices, device=device,
                              n_shots=n_shots)
    n_dev = 1 if mesh is None else len(mesh)
    if args.shot_chunk < 0:
        # shots in flight per gradient and device so that the boundary
        # strips and the state planes fit
        isz = 8 if args.x64 else 4
        args.shot_chunk = parallel.auto_shot_chunk(
            cfg, n_shots, itemsize=isz, device=device, n_devices=n_dev)
        if args.shot_chunk:
            gb = (parallel.strip_bytes_per_shot(cfg, itemsize=isz)
                  + parallel.state_bytes_per_shot(cfg, itemsize=isz)) / 2 ** 30
            print(f"shot-chunk auto: {args.shot_chunk} shots/chunk "
                  f"(~{gb:.2f} GB strips and planes/shot)")
    plan = parallel.try_plan(cfg, survey)
    use_kernels = resolve_engine(args.engine, device, dtype, plan)
    print("engine: " + (
        cuda_engine.plan_engine_name(plan, device=stf.device) if use_kernels
        else plain_engine_name(stf.device, dtype)))
    # the twin data, the --src-update synthetics and the scratch dumps run
    # through the same engine and chunks as the stage losses
    def make_fwd(survey):
        return parallel.make_forward(cfg, survey, use_kernels=use_kernels,
                                     mesh=mesh, shot_chunk=args.shot_chunk,
                                     device=device, dtype=dtype)

    fwd = make_fwd(survey)

    def tensors(params):
        return {k: torch.as_tensor(np.asarray(v)).to(device, dtype)
                for k, v in params.items()}

    def model_of(params):
        """(lam, mu, rho) of the head at params (stf left out)."""
        return head.apply({**init_t, **tensors(
            {k: v for k, v in params.items() if k != "stf"})})

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

    # --- per-trace conditioning + per-shot weights (Src_Rec.cu:145-200) --
    if args.energy_weights and survey.trace_weights is None:
        survey.trace_weights = survey_tools.energy_trace_weights(
            obs[:, 3].cpu().numpy())  # balance on the DAS channel
        print("per-trace energy weights computed from observed data "
              "(weightObsTraces, fwi_util.jl:196+)")
    # ragged spreads fold their live-trace mask into the per-trace weights
    # (padded replica traces must carry zero weight, Src_Rec.cu:87-116)
    tw_live = survey.live_trace_weights()
    per_trace = survey.win_start is not None or tw_live is not None
    S, R = survey.n_shots, survey.n_rec
    if per_trace:
        ws = (survey.win_start if survey.win_start is not None
              else np.zeros((S, R)))
        we = (survey.win_end if survey.win_end is not None
              else np.full((S, R), cfg.nt - 1))
        tw = tw_live if tw_live is not None else np.ones((S, R))
        trace_aux = tuple(torch.as_tensor(np.asarray(a)).to(device, dtype)
                          for a in (ws, we, tw))
        print("per-trace windows/weights active"
              + (" (incl. ragged live mask)" if survey.ragged else ""))
    else:
        trace_aux = ()
    weights = shot_weights(survey, device=device, dtype=dtype)

    bad = [c for c in args.channels if c not in CHANNELS]
    if bad:
        raise SystemExit(f"unknown channel(s) {bad}; choose from {CHANNELS}")

    # --- shot padding for the mesh --------------------------------------
    survey_data = survey  # the real shots, which the files hold
    if mesh is not None:
        stf, geoms, obs, weights, trace_aux = parallel.pad_shots(
            stf, geoms, obs, weights, n_dev, trace_aux)
        survey = parallel.pad_survey(survey, n_dev)
        print(f"multi-chip: {n_dev}-device shot mesh ({stf.shape[0]} shots "
              "incl. padding)")
        fwd = make_fwd(survey)
    n_pad = stf.shape[0] - n_shots

    def make_param_loss(corners):
        data_loss = build_stage_loss(
            cfg, survey, geoms, use_kernels=use_kernels, mesh=mesh,
            shot_chunk=args.shot_chunk, channels=args.channels,
            objective=args.misfit, filter_corners=corners,
            per_trace=per_trace, window=window)

        def loss(params, stf_, obs_):
            # --invert-stf's wavelets are the real shots'; the padding
            # replicates the last
            stf_used = (parallel._pad_rows(params["stf"], n_pad)
                        if "stf" in params else stf_)
            lam, mu, rho = head.apply({**init_t, **params})
            return data_loss(lam, mu, rho, stf_used, obs_, weights,
                             *trace_aux)
        return loss

    start_params = {k: init_params[k] for k in invert_names}
    if args.invert_stf:
        # joint source-model inversion: the d_stf gradients the reference
        # computes but never optimizes over (Torch_Fwi.cpp:102) become
        # parameters, without bounds
        start_params["stf"] = stf[:n_shots].cpu().numpy()
        print("joint source inversion: stf added to the parameter set")
    if args.resume:
        # resume from the latest snapshot (the reference resumes manually
        # from its per-iteration .mat dumps, Main-001:137-154)
        snaps = sorted(glob.glob(os.path.join(args.exp_name, "Results",
                                              "model_*.npz")))
        if snaps:
            with np.load(snaps[-1]) as z:
                for k in list(start_params):
                    if k in z.files:
                        start_params[k] = z[k]
            print(f"resumed from {snaps[-1]}")

    # multiscale frequency continuation: the reference's per-stage band-pass
    # list (Main-001:46-51), each stage with its own static filter
    stages = _stages(args)
    iters_per_stage = max(1, args.niter // len(stages))
    iter_offset = n_evals = nit = src_updates = 0
    seconds = 0.0
    for istage, corners in enumerate(stages):
        if args.src_update and not args.invert_stf:
            # in-loop spectral (Wiener) source re-estimation from the
            # CURRENT model's synthetics at the start of every stage (the
            # reference's if_src_update, utilities.cu:905-978)
            syn_c = fwd(*model_of(start_params), stf)
            with torch.no_grad():
                stf = torch.stack([
                    sg.apply_source_filter(stf[i], sg.source_update_filter(
                        obs[i, 3], syn_c[i, 3]))
                    for i in range(stf.shape[0])]).contiguous()
            src_updates += 1
            print(f"stage {istage + 1}: source wavelets re-estimated "
                  "(Wiener spectral correction)")
        if corners is not None:
            print(f"multiscale stage {istage + 1}/{len(stages)}: "
                  f"band {corners}")
        stage_bounds = ({k: bounds[k] for k in invert_names} if bounds
                        else None)
        rdir = os.path.join(args.exp_name, "Results")
        t0, ns0 = time.perf_counter(), time.perf_counter_ns()
        if args.optimizer == "ondevice":
            print(f"on-device L-BFGS: {iters_per_stage} iterations, "
                  f"head={args.head}")
            params_out, hist = optimize.lbfgs_on_device(
                make_param_loss(corners), start_params, iters_per_stage,
                bounds=stage_bounds, aux=(stf, obs), device=device,
                dtype=dtype)
            os.makedirs(rdir, exist_ok=True)
            with open(os.path.join(rdir, "loss.txt"), "a") as fp:
                for j, v in enumerate(hist):
                    fp.write(f"{iter_offset + j} {v}\n")
            iter_offset += len(hist)
            start_params = {k: v.cpu().numpy()
                            for k, v in params_out.items()}
            np.savez(os.path.join(rdir, f"model_{iter_offset:04d}.npz"),
                     **start_params)
            stage_evals, stage_nit, misfit = hist.n_evals, len(hist), hist[-1]
        else:
            obj = optimize.ScipyObjective(
                make_param_loss(corners), start_params, bounds=stage_bounds,
                aux=(stf, obs), device=device, dtype=dtype)
            logger = optimize.InversionLogger(rdir, obj,
                                              start_iter=iter_offset,
                                              save_mat=args.save_mat)
            print(f"L-BFGS-B: {iters_per_stage} iterations, "
                  f"head={args.head}")
            res = optimize.lbfgsb(obj, maxiter=iters_per_stage,
                                  callback=logger)
            iter_offset = logger.it
            start_params = {k: v.cpu().numpy()
                            for k, v in obj.unpack(res.x).items()}
            stage_evals, stage_nit, misfit = obj.n_evals, int(res.nit), \
                float(res.fun)
        t_stage = time.perf_counter() - t0
        seconds += t_stage
        n_evals += stage_evals
        nit += stage_nit
        cells = cfg.nz * cfg.nx * (cfg.nt - 1) * S
        per_eval = t_stage / max(stage_evals, 1)
        print(f"stage misfit {misfit:.6e} after {stage_nit} iterations "
              f"({stage_evals} evaluations, {per_eval:.3f} s each, "
              f"{cells / per_eval / 1e9:.2f} GCell/s gradient)")
        line = host_line(spans.select(ns0, time.perf_counter_ns()))
        if line:
            print(line)

    if args.scratch_dir:
        # final synthetics / residuals / observed data, the reference's
        # if_save_scratch dumps (libCUFD.cu:732-752)
        cur_stf = (parallel._pad_rows(torch.as_tensor(
            start_params["stf"]).to(device, dtype), n_pad)
                   if "stf" in start_params else stf)
        # the padding replicas are dropped from the dumps
        syn = fwd(*model_of(start_params), cur_stf)[:n_shots].cpu().numpy()
        obs_np = obs[:n_shots].cpu().numpy()
        res_d = obs_np - syn
        res_d[..., 0] = 0.0
        os.makedirs(args.scratch_dir, exist_ok=True)
        for name, d in (("Syn", syn), ("Residual", res_d),
                        ("CondObs", obs_np)):
            sio.write_shots_survey(os.path.join(args.scratch_dir, name), d,
                                   survey_data)
        print(f"scratch dumps written to {args.scratch_dir}")
    return {"n_evals": n_evals, "nit": nit, "misfit": misfit,
            "seconds": seconds, "shot_chunk": args.shot_chunk,
            "stages": len(stages), "src_updates": src_updates}


def _rtm_acoustic(cfg, survey, vpt, vpb, rho, stf, use_kernels):
    """(image, illumination) of `rtm --physics acoustic`, summed over shots:
    observed and synthetic data through the acoustic forward, their
    difference migrated with the time-derivative condition.  use_kernels:
    the kernels, in chunks of `auto_shot_chunk(acoustic=True)` shots; else
    the plain propagator on the tensors' device."""
    device = rho.device
    sz, sx = survey.src_z + cfg.npml, survey.src_x + cfg.npml
    S = survey.n_shots
    if not use_kernels:
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


def _rtm_elastic(cfg, survey, vpt, vpb, rho, stf, channels, use_kernels):
    """(image, illumination) of `rtm --physics elastic`, summed over shots:
    the zero-lag Vp condition is the Vp gradient of the L2 misfit on
    `channels`.  use_kernels: through the elastic kernels (make_cuda_misfit,
    in chunks of `auto_shot_chunk` shots) and the illumination through the
    fused forward step (cuda_engine.illumination_cuda_plan, chunk by chunk);
    else imaging.rtm_image a shot and imaging.source_illumination on the
    tensors' device."""
    device = rho.device
    vst, vsb = vpt / np.sqrt(2.2), vpb / np.sqrt(2.2)
    S = survey.n_shots
    lam_t, mu_t = (vpt ** 2 - 2.0 * vst ** 2) * rho, vst ** 2 * rho
    lam_b, mu_b = (vpb ** 2 - 2.0 * vsb ** 2) * rho, vsb ** 2 * rho
    if use_kernels:
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
        # per-cell source-energy illumination for the compensated product,
        # every shot's plane kept so the shot sum is the plain version's
        n = cfg.npml
        sz, sx = survey.src_z + n, survey.src_x + n
        ill = torch.cat([cuda_engine.illumination_cuda_plan(
            plan, lam_b.contiguous(), mu_b.contiguous(), rho, stf[a:b],
            sz[a:b], sx[a:b], survey.src_rxz[a:b])
            for a, b in parallel._chunks(S, chunk)]).sum(0)
        return img, ill
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device=device,
                                     dtype=rho.dtype)
    img = torch.zeros_like(rho)
    for i in range(S):
        g = type(geoms)(*(None if t is None else t[i] for t in geoms))
        with torch.no_grad():
            obs = propagate(cfg, lam_t, mu_t, rho, stf[i], g)
        img += imaging.rtm_image(cfg, vpb, vsb, rho, stf[i], g, obs,
                                 channels=channels)
    ill = imaging.source_illumination(cfg, lam_b, mu_b, rho, stf,
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

    use_kernels = resolve_engine("auto", device, dtype,
                                 parallel.try_plan(cfg, survey))
    if not use_kernels:
        print("engine: " + plain_engine_name(stf.device, dtype))
    if args.physics == "acoustic":
        img, illum = _rtm_acoustic(cfg, survey, pad(vp_t), pad(vp_bg), rho,
                                   stf, use_kernels)
        condition = "time-derivative (image_vel_time.cu)"
    else:
        img, illum = _rtm_elastic(cfg, survey, pad(vp_t), pad(vp_bg), rho,
                                  stf, tuple(args.channels), use_kernels)
        condition = ("zero-lag (image_vel.cu, CUDA kernels)" if use_kernels
                     else "zero-lag (image_vel.cu)")

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


def cmd_bench(args):
    """`bench`: loads bench_torch.py from the repository root and runs its
    main() (sep2023_tpu/cli.py's cmd_bench runs bench.py so), which prints
    the benchmark's JSON line.  It runs on the card only: without a CUDA
    device it raises before printing anything."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench needs a CUDA device (an NVIDIA GPU); it "
                           "has no CPU route")
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main()


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
                        help="the device every engine runs on: cuda (the "
                             "CUDA kernels, or the plain PyTorch version "
                             "with --x64 or --engine xla) or cpu")

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
                   help="float64: the plain PyTorch version on --device")
    i.add_argument("--model", default="anomaly", choices=("anomaly", "rock"),
                   help="'rock' + a velocity head = Main-005 (NO-PCS) flow")
    i.add_argument("--shot-chunk", type=int, default=-1,
                   help="shots per gradient chunk (bounds boundary-strip "
                        "memory; -1 = auto-size from the grid so the "
                        "strips fit device memory, 0 = unchunked)")
    i.add_argument("--misfit", default="l2", choices=("l2", "xcorr"),
                   help="objective: L2 (libCUFD.cu:427) or normalized "
                        "cross-correlation (if_cross_misfit, "
                        "utilities.cu:1011-1113)")
    i.add_argument("--energy-weights", action="store_true",
                   help="balance traces by 1/energy computed from the "
                        "observed data (weightObsTraces, fwi_util.jl:196+)")
    i.add_argument("--multiscale", action="store_true",
                   help="frequency-continuation over the reference's "
                        "band-pass stages (Main-001:46-51)")
    i.add_argument("--bands", default="",
                   help="custom multiscale schedule "
                        "'f0,f1,f2,f3;f0,f1,f2,f3;...': one band-pass "
                        "stage per ;-separated corner quadruple "
                        "(Main-001:46-51); implies --multiscale")
    i.add_argument("--win", default=None,
                   help="scalar taper window 'start,end' in samples applied "
                        "to obs+syn (the para if_win flag, "
                        "utilities.cu:790-884)")
    i.add_argument("--src-update", action="store_true",
                   help="re-estimate source wavelets (Wiener spectral "
                        "correction) from the current model at every stage "
                        "(if_src_update, utilities.cu:905-978)")
    i.add_argument("--invert-stf", action="store_true",
                   help="joint source-model inversion: optimize the source "
                        "wavelets via their adjoint gradient")
    i.add_argument("--resume", action="store_true",
                   help="resume from the latest Results/model_*.npz")
    i.add_argument("--para-json", default="",
                   help="run from a reference-schema para_file.json "
                        "(grid/time/PML settings + survey_fname + "
                        "data_dir_name, Parameter.cpp:17-178)")
    i.add_argument("--survey-json", default="",
                   help="load acquisition (incl. per-trace win/weights) "
                        "from a reference-schema survey_file.json")
    i.add_argument("--scratch-dir", default="",
                   help="write final syn/residual/obs shot dumps "
                        "(if_save_scratch, libCUFD.cu:732-752)")
    i.add_argument("--save-mat", action="store_true",
                   help="also write reference-format .mat snapshots per "
                        "iteration (Main-001:144-150)")
    i.add_argument("--engine", default="auto",
                   choices=("auto", "xla", "pallas"),
                   help="the JAX CLI's engine choice: pallas = the CUDA "
                        "kernels (float32; their plain versions with "
                        "--device cpu), xla = the plain PyTorch version on "
                        "--device, auto = the kernels for float32 on "
                        "--device cuda, else the plain version; a survey "
                        "no kernel plan takes raises under pallas, and "
                        "under auto on the card, naming --engine xla")
    i.add_argument("--optimizer", default="scipy",
                   choices=("scipy", "ondevice"),
                   help="scipy L-BFGS-B, or the on-device L-BFGS with a "
                        "zoom line search (optax.lbfgs's algorithm)")
    i.add_argument("--n-devices", type=int, default=0,
                   help="devices to shard the shots over (0 = every CUDA "
                        "device; with --device cpu, that many CPU shards, "
                        "0 = one)")
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
                   help="float64: the plain PyTorch version on --device")
    r.set_defaults(fn=cmd_rtm)

    b = sub.add_parser("bench", help="bench_torch.py: bench.py's sections "
                       "on the CUDA kernels, one JSON line (needs a card; "
                       "env SEP2023_TPU_BENCH_BUDGET_S, SEP2023_TPU_PROFILE)")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
