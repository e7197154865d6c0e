"""Experiment driver of the port, as a `python -m sep2023_tpu_torch` CLI.

  forward   observed-data generation + throughput report   (Main-000)

PyTorch counterpart of `sep2023_tpu/cli.py` for the forward path; `invert`,
`rtm` and `bench` come with later slices (ROADMAP M7-M9).  `--device cuda`
(the default) runs the CUDA kernel; `--device cpu` runs its plain version.
Models are synthesized (models.py) because the reference git-ignores its
Models/*.txt grids.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch import medium, models, parallel, survey_tools
from sep2023_tpu_torch.config import (SimConfig, Survey, klauder, ricker,
                                      ricker_integrated, sim_config_to_json)
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.ops import signal as sg

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

    rs = cuda_engine.check_row_survey(survey.rec_z + cfg.npml,
                                      survey.rec_x + cfg.npml)
    engine = "CUDA kernel" if device.type == "cuda" else "plain (CPU)"

    def fwd():
        data = cuda_engine.forward_cuda(
            cfg, rs, med.lam, med.mu, med.rho, stf, geoms.src_z, geoms.src_x,
            geoms.rxz)
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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
