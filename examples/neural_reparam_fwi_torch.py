"""FWI through a neural-network model reparameterization on the
PyTorch/CUDA port, the counterpart of `examples/neural_reparam_fwi.py`.

TorchFWI's headline pitch is that wrapping the propagator as an autograd
op "enables the integration of FWI with neural networks and makes it easy
to create complex inversion workflows" (reference README).  Here the
velocity model is the output of a deep-image-prior-style decoder CNN
(`sep2023_tpu_torch.decoder.Decoder`, an nn.Module), its weights trained
with torch.optim.Adam against the waveform misfit: gradients flow data ->
the boundary-saving adjoint -> vp -> the convolution kernels.  With a fixed
random latent the decoder acts as a learned regularizer (Ulyanov et al.'s
deep image prior).

The misfit is `parallel.make_cuda_misfit` (the CUDA kernels) on `--device
cuda` and `parallel.make_local_misfit` (the plain propagator) on
`--device cpu`.

Run:  python examples/neural_reparam_fwi_torch.py [outdir] [n_steps]
          [--device cuda|cpu]
(the defaults run the reference-scale grid on the card; tests drive
`invert_nn` on a tiny CPU grid).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from sep2023_tpu_torch import models, parallel
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.decoder import Decoder
from sep2023_tpu_torch.medium import pad_model, pad_model_np


def make_decoder(nz: int, nx: int, width: int = 16, scale: float = 300.0):
    """(decoder, apply): a 3-level upsampling decoder mapping a fixed
    random latent (width, nz/4, nx/4) to a (nz, nx) velocity perturbation
    in [-scale, scale] m/s (added to the smooth background).  The latent
    comes from a generator seeded 0, the weights from one seeded 1 (the
    original's PRNGKey(0) and PRNGKey(1); flax's initialisation, not its
    random numbers); apply(decoder) crops the 4-multiple upsample to
    (nz, nx)."""
    g_latent = torch.Generator().manual_seed(0)
    g_weights = torch.Generator().manual_seed(1)
    latent = torch.randn((width, -(-nz // 4), -(-nx // 4)),
                         generator=g_latent)
    dec = Decoder(latent, scale).init_lecun_normal(g_weights)
    return dec, lambda d: d()[:nz, :nx]


def invert_nn(cfg, survey, vp_bg, rho_const, stf, obs, n_steps=60, lr=2e-3,
              width=16, *, device="cuda", decoder=None):
    """Train the decoder's weights against the waveform misfit with Adam
    (optax.adam's defaults: betas 0.9, 0.999, eps 1e-8); returns (vp_out,
    losses), the loss before each step.  vp_bg: smooth background on the
    physical grid; the CNN produces the perturbation.  decoder: a Decoder
    to train (make_decoder's by default)."""
    device = torch.device(device)
    nz, nx = vp_bg.shape
    if decoder is None:
        decoder, _ = make_decoder(nz, nx, width=width)
    decoder = decoder.to(device)
    w = torch.ones(survey.n_shots, device=device)
    if device.type == "cuda":
        data_loss = parallel.make_cuda_misfit(cfg, survey)
        d_args = lambda lam, mu, rho: (lam, mu, rho, stf, obs, w)
    else:
        geoms = parallel.survey_to_geoms(survey, cfg.npml, device=device)
        data_loss = parallel.make_local_misfit(cfg)
        d_args = lambda lam, mu, rho: (lam, mu, rho, stf, geoms, obs, w)
    vp_bg = torch.as_tensor(np.asarray(vp_bg), device=device).to(
        torch.float32)
    rho = torch.full((cfg.nz, cfg.nx), float(rho_const), device=device)

    def loss_fn():
        vp_pad = pad_model(vp_bg + decoder()[:nz, :nx], cfg.npml)
        vs_pad = vp_pad / np.sqrt(3.0)
        lam = (vp_pad ** 2 - 2 * vs_pad ** 2) * rho
        mu = vs_pad ** 2 * rho
        return data_loss(*d_args(lam, mu, rho))

    opt = torch.optim.Adam(decoder.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(n_steps):
        opt.zero_grad()
        val = loss_fn()
        val.backward()
        opt.step()
        losses.append(float(val.detach()))
    with torch.no_grad():
        vp_out = (vp_bg + decoder()[:nz, :nx]).cpu().numpy()
    return vp_out, losses


def problem(device):
    """(cfg, survey, vp_true, vp_bg, rho, stf): the reference workload's
    grid (101x201 + npml 32, 20 m, 2 ms) at nt=1001, 19 surface shots,
    181 receivers on the middle row."""
    nz, nx, npml = 101, 201, 32
    cfg = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0,
                    nt=1001, dt=0.002, f0=10.0, npml=npml)
    vp_t, _, _ = models.anomaly_vp_vs_rho(nz, nx)
    vp_bg = models.smooth(vp_t, 12.0)
    src_x = np.arange(10, nx - 10, 10)
    survey = Survey(src_z=np.full(len(src_x), 1), src_x=src_x,
                    rec_z=np.full(nx - 20, nz // 2),
                    rec_x=np.arange(10, nx - 10))
    stf = torch.as_tensor(ricker(cfg.f0, cfg.nt, cfg.dt), device=device).to(
        torch.float32).expand(survey.n_shots, cfg.nt).contiguous()
    return cfg, survey, vp_t, vp_bg, 2500.0, stf


def main(outdir="scratch/neural_reparam", n_steps=80, device="cuda"):
    """Observed data from the true model, then n_steps Adam steps of the
    decoder; returns the losses, the model errors and the seconds in the
    steps."""
    os.makedirs(outdir, exist_ok=True)
    device = torch.device(device)
    cfg, survey, vp_t, vp_bg, rho, stf = problem(device)
    gen = parallel.make_forward(cfg, survey, use_kernels=True, device=device)
    vp_pad = torch.as_tensor(pad_model_np(vp_t, cfg.npml), device=device).to(
        torch.float32)
    vs_pad = vp_pad / np.sqrt(3.0)
    rr = torch.full_like(vp_pad, rho)
    obs = gen((vp_pad ** 2 - 2 * vs_pad ** 2) * rr, vs_pad ** 2 * rr, rr,
              stf)

    t0 = time.perf_counter()
    vp_out, losses = invert_nn(cfg, survey, vp_bg, rho, stf, obs,
                               n_steps=int(n_steps), device=device)
    seconds = time.perf_counter() - t0
    err0 = float(np.abs(vp_bg - vp_t).mean())
    err1 = float(np.abs(vp_out - vp_t).mean())
    np.savez(os.path.join(outdir, "neural_reparam.npz"), vp_true=vp_t,
             vp_init=vp_bg, vp_out=vp_out, losses=np.asarray(losses))
    print(f"misfit {losses[0]:.4e} -> {losses[-1]:.4e} over "
          f"{len(losses)} Adam steps ({seconds:.1f} s); mean |vp err| "
          f"{err0:.1f} -> {err1:.1f} m/s")
    return {"losses": losses, "err0": err0, "err1": err1,
            "seconds": seconds}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("args", nargs="*",
                   help="outdir, n_steps, as main() takes them")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args()
    main(*a.args, device=a.device)
