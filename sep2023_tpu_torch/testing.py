"""Problem builders shared by the GPU tests and chip_smoke.py, so both hold
the CUDA kernel against its plain version on the same cases."""
from __future__ import annotations

import numpy as np
import torch

from sep2023_tpu_torch import models
from sep2023_tpu_torch.config import SimConfig, ricker
from sep2023_tpu_torch.medium import Medium, pad_model_np
from sep2023_tpu_torch.ops import cuda_engine

# row_problem arguments of the kernel-vs-plain cases that chip_smoke.py's
# phase 3 and tests/test_torch_cuda.py both run, at 2e-5 per channel.
ROW_CASES = {
    "small exx": (44, 60, 10, 260, 2, 38, "exx"),
    "small ezz": (44, 60, 10, 260, 2, 38, "ezz"),
    "reference shape nt=301": (101, 201, 32, 301, 19, 40, "exx"),
}


def row_problem(nz, nx, npml, nt, n_shots, rec_z, das_channel="exx", *,
                device):
    """Anomaly model on an nz x nx physical grid, shots along z=1, one
    receiver row at rec_z (physical grid), float32: (cfg, rs, args) with
    args the padded-grid inputs of forward_cuda/forward_plain after rs."""
    cfg = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0,
                    nt=nt, dt=0.002, f0=10.0, npml=npml,
                    das_channel=das_channel)
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    t = lambda a: torch.as_tensor(pad_model_np(a, npml), device=device
                                  ).to(torch.float32)
    lam, mu, rho = Medium(t(vp), t(vs), t(rho)).to_lame()
    stf = torch.as_tensor(ricker(10.0, nt, 0.002), device=device
                          ).to(torch.float32).expand(n_shots, nt).contiguous()
    src_x = np.linspace(10, nx - 10, n_shots).astype(int) + npml
    rs = cuda_engine.RowSurvey(rec_z + npml, 10 + npml, nx - 20)
    return cfg, rs, (lam.contiguous(), mu.contiguous(), rho.contiguous(),
                     stf, np.full(n_shots, 1 + npml), src_x,
                     np.ones(n_shots))
