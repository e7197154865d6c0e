"""Shot-batched acquisition for the port.

Only `survey_to_geoms` of `sep2023_tpu/parallel.py` is ported so far; shot
sharding over several cards is ROADMAP M10.
"""
from __future__ import annotations

import torch

from sep2023_tpu_torch.config import Survey
from sep2023_tpu_torch.propagator import ShotGeom


def survey_to_geoms(survey: Survey, npml: int, *, device,
                    dtype=torch.float32) -> ShotGeom:
    """Batched ShotGeom (leading shot axis) with the npml offset applied
    (Src_Rec.cu:87-116 does the same when parsing the survey JSON).  Ragged
    surveys carry their per-shot padded (S, R_max) spreads straight through
    (padding replicates real receivers; zero its weights via
    `survey.live_trace_weights()`)."""
    S = survey.n_shots
    idx = lambda a: torch.as_tensor(a + npml, dtype=torch.int64,
                                    device=device)
    return ShotGeom(
        src_z=idx(survey.src_z),
        src_x=idx(survey.src_x),
        rxz=torch.as_tensor(survey.src_rxz, dtype=dtype, device=device),
        rec_z=idx(survey.rec_z).expand(S, survey.n_rec),
        rec_x=idx(survey.rec_x).expand(S, survey.n_rec),
    )
