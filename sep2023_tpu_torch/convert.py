"""Arrays of the JAX package to the port's tensors.

The tests feed one problem to both packages: they build it with
`sep2023_tpu`, take its arrays as numpy (`np.asarray`), and hand them here.
Nothing in this module imports jax; a geometry is read by its field names.
"""
from __future__ import annotations

import numpy as np
import torch

from sep2023_tpu_torch.acoustic import AcGeom
from sep2023_tpu_torch.config import Survey
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.propagator import ShotGeom


def params_from_numpy(lam, mu, rho, stf, geoms, *, device,
                      dtype=torch.float32):
    """(lam, mu, rho, stf, ShotGeom) as tensors on `device`: material planes
    and wavelets in `dtype`, indices as int64.  `geoms` is any object with
    the ShotGeom field names (the JAX ShotGeom included), shot axis first."""
    t = lambda a: torch.tensor(np.asarray(a), device=device, dtype=dtype)
    i = lambda a: torch.tensor(np.asarray(a), device=device,
                               dtype=torch.int64)
    das_w = getattr(geoms, "das_w", None)
    geom = ShotGeom(src_z=i(geoms.src_z), src_x=i(geoms.src_x),
                    rxz=t(geoms.rxz), rec_z=i(geoms.rec_z),
                    rec_x=i(geoms.rec_x),
                    das_w=None if das_w is None else t(das_w))
    return t(lam), t(mu), t(rho), t(stf), geom


def acgeom_from_jax(geom, *, device="cpu") -> AcGeom:
    """The port's AcGeom on `device` from any object with the AcGeom field
    names (the JAX package's AcGeom of numpy or jax arrays included), index
    arrays as int64, with or without the shot axis."""
    i = lambda a: torch.tensor(np.asarray(a), device=device,
                               dtype=torch.int64)
    return AcGeom(src_z=i(geom.src_z), src_x=i(geom.src_x),
                  rec_z=i(geom.rec_z), rec_x=i(geom.rec_x))


def survey_from_jax(survey) -> Survey:
    """The port's Survey from any object with the Survey field names (the
    JAX package's Survey included), field by field as numpy."""
    opt = lambda a: None if a is None else np.asarray(a)
    return Survey(
        src_z=np.asarray(survey.src_z), src_x=np.asarray(survey.src_x),
        rec_z=np.asarray(survey.rec_z), rec_x=np.asarray(survey.rec_x),
        src_rxz=opt(survey.src_rxz), win_start=opt(survey.win_start),
        win_end=opt(survey.win_end), trace_weights=opt(survey.trace_weights),
        src_weights=opt(survey.src_weights), rec_live=opt(survey.rec_live))


def plan_inputs(cfg, survey, das_w=None):
    """What both packages' planners and plan propagators take, from one
    physical-grid Survey (either package's) and its numpy (R, 3) fiber
    weights: ((rec_z, rec_x, das_w), (src_z, src_x, rxz)) on the padded
    grid, receivers in the survey's order."""
    n = cfg.npml
    das_w = None if das_w is None else np.asarray(das_w, np.float64)
    return ((np.asarray(survey.rec_z) + n, np.asarray(survey.rec_x) + n,
             das_w),
            (np.asarray(survey.src_z) + n, np.asarray(survey.src_x) + n,
             np.asarray(survey.src_rxz, np.float32)))


def fiber_survey_from_jax(fs) -> cuda_engine.FiberSurvey:
    """The port's FiberSurvey from the JAX package's (read by its field
    names).  There receiver r sits on lane rec_x[r] at the row that its
    layer's row map holds for that lane; both keep the caller's receiver
    order, so data compare without a permutation."""
    rec_z = [fs.rowmaps[k][x] for k, x in zip(fs.rec_layer, fs.rec_x)]
    return cuda_engine.make_fiber_survey(rec_z, fs.rec_x, fs.weights)
