"""The benchmark's inputs, drawn from the seed: the smooth perturbation of
a configuration's true model and the noise on its observed data.  Both
sides, the port and the plain reference, get the same arrays; each works
out the rest itself.  Nothing here imports the port."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def _gauss_smooth(a: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian smoothing of (..., nz, nx) with reflected edges."""
    def along_last(t):
        r = int(min(round(3 * sigma), t.shape[-1] - 1))
        x = torch.arange(-r, r + 1, device=t.device, dtype=t.dtype)
        k = torch.exp(-0.5 * (x / sigma) ** 2)
        k = (k / k.sum()).reshape(1, 1, -1)
        flat = t.reshape(-1, 1, t.shape[-1])
        out = F.conv1d(F.pad(flat, (r, r), mode="reflect"), k)
        return out.reshape(t.shape)

    return along_last(along_last(a).transpose(-1, -2)).transpose(-1, -2)


def draw(cfg: dict, seed: int, device):
    """(fields, noise) of the seed: fields (n_params, nz, nx) float64 numpy,
    smooth and scaled to max |.| = 1 each; noise (S, R, nt) float32 on
    `device`, unit white noise for ett.  One generator on `device`, drawn
    in this order, so the same seed gives the same arrays."""
    g = generator(seed, device)
    n = len(cfg["params"])
    white = torch.randn((n, cfg["nz"], cfg["nx"]), generator=g,
                        device=device, dtype=torch.float64)
    sm = _gauss_smooth(white, cfg["assumed"]["perturbation"]["smooth_cells"])
    sm = sm / sm.abs().amax(dim=(-2, -1), keepdim=True)
    noise = torch.randn((cfg["n_shots"], cfg["n_rec"], cfg["nt"]),
                        generator=g, device=device, dtype=torch.float32)
    return sm.cpu().numpy(), noise


def perturbed(true: dict, fields: np.ndarray, cfg: dict) -> dict:
    """The seed's true model: the published one plus each parameter's
    amplitude times its field, clipped where the configuration says."""
    pert = cfg["assumed"]["perturbation"]
    out = dict(true)
    for i, name in enumerate(cfg["params"]):
        lo, hi = pert.get("clip", {}).get(name, (-np.inf, np.inf))
        out[name] = np.clip(np.asarray(true[name], np.float64)
                            + pert["amplitude"][name] * fields[i], lo, hi)
    return out


def add_noise(obs: torch.Tensor, noise: torch.Tensor, cfg: dict):
    """obs (S, 4, R, nt) with the noise on ett, in place: rel_rms times the
    clean ett's rms (taken in float64) times the unit noise."""
    rel = cfg["assumed"]["noise"]["rel_rms"]
    ett = obs[:, 3]
    rms = torch.sqrt((ett.double() ** 2).mean()).to(ett.dtype)
    obs[:, 3] = ett + rel * rms * noise.to(ett.device, ett.dtype)
    return obs
