"""The plain reference of a twin experiment: the survey, the wavelets, the
true model, the observed data, the start model and the head's map onto
(lam, mu, rho), rebuilt from a configuration file and the seed's fields,
and the misfit's value and gradient at any point.

It imports nothing of the port.  The configuration's own module
(`configs/<name>.py`) gives its published true model and its head; the
rest is shared here.  Every array the port derives (padded models,
masks, CPML profiles, observed data) is worked out again.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

from fwibench import inputs
from fwibench.reference import elastic


# -- survey and wavelets ------------------------------------------------------

def grid(cfg: dict) -> elastic.Grid:
    n = cfg["npml"]
    return elastic.Grid(nz=cfg["nz"] + 2 * n, nx=cfg["nx"] + 2 * n,
                        dz=cfg["dz"], dx=cfg["dx"], nt=cfg["nt"],
                        dt=cfg["dt"], f0=cfg["f0"], npml=n)


def survey(cfg: dict):
    """(src_z, src_x, rec_z, rec_x) on the physical grid, as the
    configuration lays them out."""
    src_x = np.arange(cfg["src_x0"], cfg["src_x0"] + cfg["n_shots"]
                      * cfg["src_dx"], cfg["src_dx"])
    rec_x = np.arange(cfg["rec_x0"], cfg["rec_x0"] + cfg["n_rec"])
    return (np.full(cfg["n_shots"], cfg["src_z"]), src_x,
            np.full(cfg["n_rec"], cfg["rec_z"]), rec_x)


def geom(cfg: dict, *, device, dtype) -> elastic.Geom:
    src_z, src_x, rec_z, rec_x = survey(cfg)
    n, S = cfg["npml"], cfg["n_shots"]

    def idx(a):
        return torch.as_tensor(a + n, dtype=torch.int64, device=device)

    return elastic.Geom(idx(src_z), idx(src_x),
                        torch.ones(S, device=device, dtype=dtype),
                        idx(rec_z).expand(S, -1), idx(rec_x).expand(S, -1))


def ricker(f0, nt, dt, amp=1.0e7, delay_cycles=1.2):
    t = np.arange(nt) * dt
    e = (np.pi * f0) ** 2
    td = t - delay_cycles / f0
    return (1.0 - 2.0 * e * td ** 2) * np.exp(-e * td ** 2) * amp


def taper(nt, ratio=0.001):
    """1 over [0, nt-1] with sin^2 ramps of ratio nt samples at both ends
    (float64)."""
    ramp = max(ratio * nt, 1.0)
    t = np.arange(nt, dtype=np.float64)
    up = np.clip(t / ramp, 0.0, 1.0)
    down = np.clip((nt - 1 - t) / ramp, 0.0, 1.0)
    return np.sin(0.5 * math.pi * up) ** 2 * np.sin(0.5 * math.pi * down) ** 2


def wavelets(cfg: dict, *, device, dtype):
    """(S, nt): the Ricker wavelet, cast, times the end taper cast, one
    row a shot."""
    w = torch.as_tensor(ricker(cfg["f0"], cfg["nt"], cfg["dt"])).to(
        device, dtype)
    tp = torch.as_tensor(taper(cfg["nt"])).to(device, dtype)
    return (w.expand(cfg["n_shots"], -1) * tp).contiguous()


# -- models and heads ---------------------------------------------------------

def smooth(model: np.ndarray, sigma: float) -> np.ndarray:
    return gaussian_filter(model, sigma)


def pad(a, npml: int):
    """Edge-replicate a physical (nz, nx) tensor by npml on all sides."""
    nz, nx = a.shape[-2:]
    iz = torch.arange(-npml, nz + npml, device=a.device).clamp(0, nz - 1)
    ix = torch.arange(-npml, nx + npml, device=a.device).clamp(0, nx - 1)
    return a[..., iz, :][..., ix]


def resize_and_pad(a, nz: int, nx: int, npml: int):
    r = F.interpolate(a[None, None], size=(nz, nx), mode="bilinear",
                      align_corners=False)[0, 0]
    return pad(r, npml)


def inversion_mask(cfg: dict) -> np.ndarray:
    """1 on the physical region below its first freeze_top_rows rows, 0
    on the absorbing collar and those rows."""
    n = cfg["npml"]
    m = np.zeros((cfg["nz"] + 2 * n, cfg["nx"] + 2 * n))
    m[n:n + cfg["nz"], n:n + cfg["nx"]] = 1.0
    m[n:n + cfg["freeze_top_rows"], :] = 0.0
    return m


@dataclasses.dataclass
class Twin:
    """A configuration's twin experiment in plain PyTorch."""

    cfg: dict
    module: object          # configs/<name>.py: true_model, to_lame
    device: torch.device
    dtype: torch.dtype
    true: dict = None       # the seed's true model (physical, float64)
    start: dict = None      # the published smoothed start (float64)

    def __post_init__(self):
        self.g = grid(self.cfg)
        self.geom = geom(self.cfg, device=self.device, dtype=self.dtype)
        self.stf = wavelets(self.cfg, device=self.device, dtype=self.dtype)
        published = self.module.true_model(self.cfg["nz"], self.cfg["nx"])
        self.start = {k: smooth(published[k], self.cfg["smooth_sigma"])
                      for k in self.cfg["params"]}
        self._published = published
        f64 = torch.float64
        n = self.cfg["npml"]
        self.mask = torch.as_tensor(inversion_mask(self.cfg), dtype=f64)
        self.refs = {k: resize_and_pad(torch.as_tensor(v, dtype=f64),
                                       self.cfg["nz"], self.cfg["nx"], n)
                     for k, v in self.start.items()}

    def set_fields(self, fields: np.ndarray):
        self.true = inputs.perturbed(self._published, fields, self.cfg)

    def x0(self) -> np.ndarray:
        return np.concatenate([self.start[k].ravel()
                               for k in self.cfg["params"]])

    def unpack(self, x: np.ndarray) -> dict:
        out, i = {}, 0
        shape = (self.cfg["nz"], self.cfg["nx"])
        for k in self.cfg["params"]:
            size = shape[0] * shape[1]
            out[k] = torch.as_tensor(x[i:i + size].reshape(shape)).to(
                self.device, self.dtype)
            i += size
        return out

    def lame(self, params: dict):
        """(lam, mu, rho) on the padded grid: each parameter resized and
        padded, blended with the start model outside the mask, mapped by
        the configuration's head."""
        n = self.cfg["npml"]
        blended = []
        for k in self.cfg["params"]:
            p = params[k]
            m = self.mask.to(p.device, p.dtype)
            r = self.refs[k].to(p.device, p.dtype)
            blended.append(m * resize_and_pad(p, self.cfg["nz"],
                                              self.cfg["nx"], n)
                           + (1.0 - m) * r)
        return self.module.to_lame(*blended)

    def true_lame(self):
        return self.lame({k: torch.as_tensor(v).to(self.device, self.dtype)
                          for k, v in self.true.items()})

    def forward(self, lam, mu, rho):
        """Data (S, 4, R, nt) of all shots."""
        return elastic.forward(self.g, lam, mu, rho, self.stf, self.geom)

    def observed(self, noise: torch.Tensor):
        """The true model's data with the seed's noise on ett."""
        return inputs.add_noise(self.forward(*self.true_lame()), noise,
                                self.cfg)

    def value_and_grad(self, x: np.ndarray, obs: torch.Tensor):
        """(loss, packed float64 gradient) at x: 0.5 sum over shots,
        receivers and samples 1.. of the ett residual squared."""
        params = {k: v.requires_grad_() for k, v in self.unpack(x).items()}
        syn = elastic.propagate(self.g, *self.lame(params), self.stf,
                                self.geom)
        r = obs[:, 3, :, 1:] - syn[:, 3, :, 1:]
        loss = 0.5 * (r * r).sum()
        grads = torch.autograd.grad(loss, [params[k]
                                           for k in self.cfg["params"]])
        return float(loss.detach()), np.concatenate(
            [g.detach().double().cpu().numpy().ravel() for g in grads])
