"""Configuration objects for the PyTorch/CUDA port.

A numpy-only copy of `sep2023_tpu/config.py`: importing that package would
import jax, which the port never does.  tests/test_torch_fd_medium.py pins
the two equal.

Replaces the reference's filesystem JSON side-channel (para_file.json /
survey_file.json parsed by rapidjson in
`DAS_Waveform_Inversion/Ops/FWI/Src/Parameter.cpp:17-178` and
`Src_Rec.cu:20-282`) with in-process dataclasses.  JSON round-trip helpers are
provided for compatibility with the reference file schema
(`Ops/FWI/fwi_utils.py:46-124`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

C1 = 9.0 / 8.0  # O(4) staggered-grid FD coefficients (elasticSolver.py:315-316)
C2 = 1.0 / 24.0
SRC_SCALE = 1500.0 ** 2  # explosive source scale (utilities.cu:531)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Padded simulation grid: nz x nx INCLUDES the 2*npml absorbing collar.

    The reference additionally pads the bottom with ``nPad`` rows so nz is a
    multiple of 32 for CUDA tiling (`propagator.py:95`).  This build is
    nPad-free: the kernels mask the ragged edge themselves; callers that speak the
    reference schema strip nPad at the boundary (see `io.py`).
    """

    nz: int
    nx: int
    dz: float
    dx: float
    npml: int = 32

    @property
    def nz_phys(self) -> int:
        return self.nz - 2 * self.npml

    @property
    def nx_phys(self) -> int:
        return self.nx - 2 * self.npml

    @property
    def shape(self) -> tuple:
        return (self.nz, self.nx)

    def interior_slices(self):
        return (slice(self.npml, self.nz - self.npml),
                slice(self.npml, self.nx - self.npml))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static (hashable) simulation configuration.

    Mirrors para_file.json fields (`fwi_utils.py:46-83`): nz, nx, dz, dx,
    nSteps -> nt, dt, f0, nPoints_pml -> npml.  `das_channel` selects which
    fiber-strain channel feeds the 'ett' record: 'exx' (horizontal fiber,
    `utilities.cu:593-615`) or 'ezz' (vertical fiber, `utilities.cu:620-641`).
    """

    nz: int
    nx: int
    dz: float
    dx: float
    nt: int
    dt: float
    f0: float
    npml: int = 32
    das_channel: str = "exx"
    src_scale: float = SRC_SCALE
    n_bnd_layers: int = 5  # boundary-saving strip depth (Boundary.cu:19)

    @property
    def grid(self) -> Grid:
        return Grid(self.nz, self.nx, self.dz, self.dx, self.npml)

    def courant_number(self, vp_max: float) -> float:
        """Stability bound of the O(4) scheme (utilities.cu:225-241)."""
        dh_min = min(self.dz, self.dx)
        return vp_max * self.dt * np.sqrt(2.0) * (C1 + C2) / dh_min

    def check_stability(self, vp_max: float) -> None:
        c = self.courant_number(float(vp_max))
        if c > 1.0:
            raise ValueError(
                f"Courant number {c:.4f} > 1: unstable. Reduce dt or refine "
                f"the grid (vp_max={vp_max}, dt={self.dt}, dh={min(self.dz, self.dx)}).")


@dataclasses.dataclass
class Survey:
    """Acquisition geometry. Indices are in the PHYSICAL (un-padded) grid; the
    npml offset is applied internally (the reference applies it when parsing
    survey_file.json, `Src_Rec.cu:87-116`).

    rec_z/rec_x are either (R,) — every shot shares the spread, the
    `fwi_utils.py:87-124` layout — or (S, R_max) for per-shot heterogeneous
    ("ragged") spreads, the general case the reference parses per shot
    (`Src_Rec.cu:87-116`: nrec, z_rec, x_rec per shot<i>).  Ragged spreads
    are padded to R_max by replicating the shot's last receiver; `rec_live`
    (S, R_max) is 0 on padding and MUST multiply into the trace weights so
    padded traces never contribute to the misfit (the loss builders /
    drivers do this via `live_trace_weights`).

    src_rxz is the sxx/szz source moment ratio (default 1.0: isotropic
    explosive source, `utilities.cu:524-552`).

    Optional per-trace metadata (the survey-JSON win_start/win_end/weights /
    src_weight entries parsed by `Src_Rec.cu:145-200`): pass them to
    `ops.misfit` as window bounds / multiplicative trace weights.
    """

    src_z: np.ndarray  # (S,) int
    src_x: np.ndarray  # (S,) int
    rec_z: np.ndarray  # (R,) int or (S, R_max) int
    rec_x: np.ndarray  # (R,) int or (S, R_max) int
    src_rxz: Optional[np.ndarray] = None   # (S,) float
    win_start: Optional[np.ndarray] = None  # (S, R) samples
    win_end: Optional[np.ndarray] = None    # (S, R) samples
    trace_weights: Optional[np.ndarray] = None  # (S, R)
    src_weights: Optional[np.ndarray] = None    # (S,)
    rec_live: Optional[np.ndarray] = None       # (S, R_max) 0/1, ragged only

    def __post_init__(self):
        self.src_z = np.asarray(self.src_z, dtype=np.int32)
        self.src_x = np.asarray(self.src_x, dtype=np.int32)
        self.rec_z = np.asarray(self.rec_z, dtype=np.int32)
        self.rec_x = np.asarray(self.rec_x, dtype=np.int32)
        if self.src_rxz is None:
            self.src_rxz = np.ones(self.src_z.shape, dtype=np.float32)
        else:
            self.src_rxz = np.asarray(self.src_rxz, dtype=np.float32)
        if self.rec_live is not None:
            self.rec_live = np.asarray(self.rec_live, dtype=np.float32)

    @property
    def n_shots(self) -> int:
        return int(self.src_z.shape[0])

    @property
    def n_rec(self) -> int:
        return int(self.rec_z.shape[-1])

    @property
    def ragged(self) -> bool:
        return self.rec_z.ndim == 2

    def shot_rec(self, i: int):
        """(rec_z, rec_x, n_live) of shot i (padding stripped)."""
        rz = self.rec_z[i] if self.ragged else self.rec_z
        rx = self.rec_x[i] if self.ragged else self.rec_x
        n = (int(self.rec_live[i].sum())
             if (self.ragged and self.rec_live is not None) else len(rz))
        return rz[:n], rx[:n], n

    def live_trace_weights(self) -> Optional[np.ndarray]:
        """(S, R) trace weights with ragged padding zeroed, or None when no
        conditioning applies.  Every misfit over a ragged survey must use
        this so replicated padding traces carry zero weight."""
        w = self.trace_weights
        if self.rec_live is not None:
            w = self.rec_live if w is None else w * self.rec_live
        return w

    # -- reference-schema JSON round trip ------------------------------------
    def to_json(self, fname: str) -> None:
        survey = {"nShots": self.n_shots}
        for i in range(self.n_shots):
            rz, rx, n_live = self.shot_rec(i)
            shot = {
                "z_src": int(self.src_z[i]),
                "x_src": int(self.src_x[i]),
                "nrec": n_live,
                "z_rec": rz.tolist(),
                "x_rec": rx.tolist(),
                "src_rxz": float(self.src_rxz[i]),
            }
            if self.win_start is not None:
                shot["win_start"] = np.asarray(
                    self.win_start[i][:n_live]).tolist()
                shot["win_end"] = np.asarray(
                    self.win_end[i][:n_live]).tolist()
            if self.trace_weights is not None:
                shot["weights"] = np.asarray(
                    self.trace_weights[i][:n_live]).tolist()
            if self.src_weights is not None:
                shot["src_weight"] = float(self.src_weights[i])
            survey[f"shot{i}"] = shot
        with open(fname, "w") as fp:
            json.dump(survey, fp)

    @classmethod
    def from_json(cls, fname: str) -> "Survey":
        """Parse a reference-schema survey file, INCLUDING heterogeneous
        per-shot receiver spreads (`Src_Rec.cu:87-116` reads nrec / z_rec /
        x_rec per shot<i>): identical spreads collapse to the shared (R,)
        layout; differing ones become a padded ragged (S, R_max) survey
        with `rec_live` masking the padding."""
        with open(fname) as fp:
            d = json.load(fp)
        n = d["nShots"]
        shots = [d[f"shot{i}"] for i in range(n)]
        rec_zs = [np.asarray(s["z_rec"]) for s in shots]
        rec_xs = [np.asarray(s["x_rec"]) for s in shots]
        shared = all(
            len(rz) == len(rec_zs[0]) and (rz == rec_zs[0]).all()
            and (rx == rec_xs[0]).all()
            for rz, rx in zip(rec_zs, rec_xs))
        # per-trace aux arrays are padded alongside the spreads (weight 0 on
        # padding comes from rec_live via live_trace_weights)
        r_max = max(len(rz) for rz in rec_zs)

        def pad_to(a, fill_last=True):
            a = np.asarray(a, dtype=np.float64)
            if len(a) == r_max:
                return a
            fill = a[-1] if fill_last else 0.0
            return np.concatenate([a, np.full(r_max - len(a), fill)])

        def opt(key):
            if key not in shots[0]:
                return None
            return np.array([pad_to(s[key]) for s in shots])

        if shared:
            rec_z, rec_x, rec_live = rec_zs[0], rec_xs[0], None
        else:
            rec_z = np.array([pad_to(rz) for rz in rec_zs], dtype=np.int64)
            rec_x = np.array([pad_to(rx) for rx in rec_xs], dtype=np.int64)
            rec_live = np.array(
                [np.arange(r_max) < len(rz) for rz in rec_zs], np.float32)
        return cls(
            src_z=np.array([s["z_src"] for s in shots]),
            src_x=np.array([s["x_src"] for s in shots]),
            rec_z=rec_z,
            rec_x=rec_x,
            src_rxz=np.array([s.get("src_rxz", 1.0) for s in shots]),
            win_start=opt("win_start"),
            win_end=opt("win_end"),
            trace_weights=opt("weights"),
            src_weights=(np.array([s["src_weight"] for s in shots])
                         if "src_weight" in shots[0] else None),
            rec_live=rec_live,
        )


def sim_config_to_json(cfg: SimConfig, para_fname: str, survey_fname: str,
                       data_dir_name: str, **extra) -> None:
    """Write a reference-compatible para_file.json (fwi_utils.py:46-83)."""
    para = {
        "nz": cfg.nz, "nx": cfg.nx, "dz": cfg.dz, "dx": cfg.dx,
        "nSteps": cfg.nt, "dt": cfg.dt, "f0": cfg.f0,
        "nPoints_pml": cfg.npml, "nPad": 0,
        "survey_fname": survey_fname, "data_dir_name": data_dir_name,
    }
    para.update(extra)
    with open(para_fname, "w") as fp:
        json.dump(para, fp)


def sim_config_from_json(para_fname: str) -> SimConfig:
    with open(para_fname) as fp:
        d = json.load(fp)
    npad = int(d.get("nPad", 0))
    return SimConfig(
        nz=int(d["nz"]) - npad, nx=int(d["nx"]), dz=float(d["dz"]),
        dx=float(d["dx"]), nt=int(d["nSteps"]), dt=float(d["dt"]),
        f0=float(d["f0"]), npml=int(d["nPoints_pml"]),
    )


def ricker(f0: float, nt: int, dt: float, amp: float = 1.0e7,
           delay_cycles: float = 1.2) -> np.ndarray:
    """Ricker wavelet, delay 1.2/f0, amplitude 1e7 (fwi_utils.py:127-140)."""
    t = np.arange(nt) * dt
    e = (np.pi * f0) ** 2
    td = t - delay_cycles / f0
    return ((1.0 - 2.0 * e * td ** 2) * np.exp(-e * td ** 2) * amp).astype(np.float64)


def ricker_integrated(f0: float, nt: int, dt: float, amp: float = 1.0e7) -> np.ndarray:
    """Time-integrated Ricker (the Julia-era variant, fwi_util.jl:99-116)."""
    s = ricker(f0, nt, dt, amp)
    return np.cumsum(s) * dt


def klauder(f0: float, nt: int, dt: float, f_min: float = None,
            f_max: float = None, sweep_time: float = 7.0,
            amp: float = 1.0e7) -> np.ndarray:
    """Klauder (vibroseis autocorrelation) wavelet (fwi_util.jl:136-172).

    K(t) = Re[ sin(pi k t (T - t)) / (pi k t) * exp(2 pi i f_c t) ],
    with sweep rate k = (f_max - f_min)/T and center frequency f_c.
    """
    if f_min is None:
        f_min = 0.5 * f0
    if f_max is None:
        f_max = 1.5 * f0
    T = sweep_time
    k = (f_max - f_min) / T
    fc = 0.5 * (f_min + f_max)
    t = np.arange(nt) * dt - 1.2 / f0
    denom = np.pi * k * t
    core = np.where(np.abs(denom) < 1e-12, T,
                    np.sin(np.pi * k * t * (T - t)) / np.where(
                        np.abs(denom) < 1e-12, 1.0, denom))
    return (core * np.cos(2 * np.pi * fc * t) * amp / T).astype(np.float64)
