"""Seismogram and model I/O.

Reference-compatible binary shot files: `Shot_{pr,vx,vz,ett}<id>.bin`,
float32, (nrec, nSteps) row-major — the format written/read by
`libCUFD.cu:216-223, 755-768` (fileBinWrite/fileBinLoad, utilities.cu:10-31).
A user of the reference can point this framework at an existing Data/
directory and vice versa.

The numpy path of `sep2023_tpu/io.py`, without its native sepio helper; both
write and read the same files.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from sep2023_tpu_torch.propagator import CHANNELS

_CHANNEL_FILE = {"pr": "Shot_pr{}.bin", "vx": "Shot_vx{}.bin",
                 "vz": "Shot_vz{}.bin", "ett": "Shot_ett{}.bin"}


def write_shot(data_dir: str, shot_id: int, data: np.ndarray) -> None:
    """data: (4, nrec, nt) — one file per channel, float32."""
    os.makedirs(data_dir, exist_ok=True)
    for c, name in enumerate(CHANNELS):
        path = os.path.join(data_dir, _CHANNEL_FILE[name].format(shot_id))
        np.asarray(data[c], dtype=np.float32).tofile(path)


def read_shot(data_dir: str, shot_id: int, nrec: int, nt: int) -> np.ndarray:
    out = np.zeros((len(CHANNELS), nrec, nt), dtype=np.float32)
    for c, name in enumerate(CHANNELS):
        path = os.path.join(data_dir, _CHANNEL_FILE[name].format(shot_id))
        out[c] = np.fromfile(path, dtype=np.float32).reshape(nrec, nt)
    return out


def write_shots(data_dir: str, data: np.ndarray,
                shot_ids: Sequence[int] | None = None) -> None:
    """data: (S, 4, nrec, nt)."""
    S = data.shape[0]
    ids = list(range(S)) if shot_ids is None else list(shot_ids)
    for i, sid in enumerate(ids):
        write_shot(data_dir, sid, data[i])


def read_shots(data_dir: str, n_shots: int, nrec: int, nt: int,
               shot_ids: Sequence[int] | None = None) -> np.ndarray:
    ids = list(range(n_shots)) if shot_ids is None else list(shot_ids)
    return np.stack([read_shot(data_dir, sid, nrec, nt) for sid in ids])


def write_shots_survey(data_dir: str, data: np.ndarray, survey,
                       shot_ids: Sequence[int] | None = None) -> None:
    """write_shots for a (possibly ragged) Survey: each shot's file holds
    its OWN nrec_i traces (padding stripped), the exact per-shot layout the
    reference writes (`libCUFD.cu:755-768`)."""
    if not getattr(survey, "ragged", False):
        write_shots(data_dir, data, shot_ids)
        return
    ids = (list(range(data.shape[0])) if shot_ids is None
           else list(shot_ids))
    for i, sid in enumerate(ids):
        _, _, n_live = survey.shot_rec(i)
        write_shot(data_dir, sid, data[i, :, :n_live])


def read_shots_survey(data_dir: str, survey, nt: int) -> np.ndarray:
    """read_shots for a (possibly ragged) Survey: per-shot files of nrec_i
    traces are padded back to (S, 4, R_max, nt) by replicating the last
    trace (matching the padded geometry, whose extra receivers replicate the
    last one; they carry zero weight either way)."""
    if not getattr(survey, "ragged", False):
        return read_shots(data_dir, survey.n_shots, survey.n_rec, nt)
    r_max = survey.n_rec
    out = np.zeros((survey.n_shots, len(CHANNELS), r_max, nt), np.float32)
    for i in range(survey.n_shots):
        _, _, n_live = survey.shot_rec(i)
        d = read_shot(data_dir, i, n_live, nt)
        out[i, :, :n_live] = d
        out[i, :, n_live:] = d[:, -1:]
    return out


def save_model_npz(path: str, **arrays) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def load_model_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_model_txt(path: str) -> np.ndarray:
    """Whitespace text model grids, the reference's Models/*.txt format
    (Main-001:78-80)."""
    return np.loadtxt(path).astype(np.float32)
