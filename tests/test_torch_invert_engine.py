"""`invert --engine` of the port, the JAX CLI's spelling, and the engine
choice behind it (`cli.resolve_engine`), made from the survey's plan: xla
is the plain PyTorch version on whatever device --device names; pallas the
kernel route (the CUDA kernels on the card, their plain versions on the
CPU), and raises in float64 or for a survey no plan takes, naming --engine
xla; auto takes the kernel route for float32 on --device cuda, where a
survey no plan takes raises as under pallas, and the plain version
otherwise.  Through `cli.main` over the six (engine, device) pairs on a
machine without a card, where --device cuda raises as it always has; the
runnable pairs stop after --generate_data, and their engine line names
what ran, with its device and dtype.
"""
import os

import numpy as np
import pytest
import torch

from sep2023_tpu_torch import api, cli, parallel
from sep2023_tpu_torch.config import SimConfig, Survey
from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.testing import corner_api_problem
from torch_invert_parity import TINY

F32_TINY = [a for a in TINY if a != "--x64"]


@pytest.mark.parametrize("engine,device,raises", [
    ("auto", "cpu", None),
    ("xla", "cpu", None),
    ("pallas", "cpu", None),
    ("auto", "cuda", (RuntimeError, "needs a CUDA device")),
    ("pallas", "cuda", (RuntimeError, "needs a CUDA device")),
    ("xla", "cuda", (RuntimeError, "needs a CUDA device")),
])
def test_engine_follows_device(tmp_path, monkeypatch, capsys, engine, device,
                               raises):
    """--engine pallas computes float32, so its row runs without --x64 and
    names the kernels' plain versions, not the kernels."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["invert", *(F32_TINY if engine == "pallas" else TINY),
            "--engine", engine, "--device", device, "--exp-name",
            str(tmp_path), "--generate_data", "--data-dir",
            str(tmp_path / "data")]
    if raises is not None:
        exc, match = raises
        with pytest.raises(exc, match=match):
            cli.main(argv)
        return
    assert cli.main(argv) is None
    want = ("engine: plain versions of the CUDA kernels (cpu, float32), "
            "receiver row" if engine == "pallas"
            else "engine: plain PyTorch (cpu, float64)")
    out = capsys.readouterr().out
    assert want in out and "engine: CUDA kernels" not in out
    assert os.path.exists(tmp_path / "data" / "Shot_ett0.bin")


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("engine,device,dtype,planned,want", [
    ("auto", "cuda", F32, True, "kernels"),
    ("auto", "cuda", F32, False, "--engine xla runs it"),
    ("auto", "cuda", F64, True, "plain"),
    ("auto", "cuda", F64, False, "plain"),
    ("auto", "cpu", F32, True, "plain"),
    ("auto", "cpu", F32, False, "plain"),
    ("auto", "cpu", F64, False, "plain"),
    ("xla", "cuda", F32, True, "plain"),
    ("xla", "cuda", F32, False, "plain"),
    ("xla", "cuda", F64, False, "plain"),
    ("xla", "cpu", F64, True, "plain"),
    ("pallas", "cuda", F32, True, "kernels"),
    ("pallas", "cpu", F32, True, "kernels"),
    ("pallas", "cpu", F32, False, "--engine xla runs it on .* --device cpu"),
    ("pallas", "cuda", F64, True, "computes in float32"),
    ("pallas", "cpu", F64, True, "computes in float32.*--engine xla"),
    ("pallas", "cuda", F32, False, "--engine xla runs it"),
])
def test_resolve_engine(engine, device, dtype, planned, want):
    """Every row of the engine table: the kernel route, the plain version
    on the device asked for, or a ValueError naming the way out.  The plain
    version runs on the card only under --engine xla or in float64."""
    plan = object() if planned else None
    if want in ("kernels", "plain"):
        assert cli.resolve_engine(engine, device, dtype, plan) == \
            (want == "kernels")
        return
    with pytest.raises(ValueError, match=want):
        cli.resolve_engine(engine, device, dtype, plan)


def test_plain_engine_name():
    assert cli.plain_engine_name(torch.device("cuda", 0), F64) == \
        "plain PyTorch (cuda:0, float64)"
    assert cli.plain_engine_name(torch.device("cpu"), F32) == \
        "plain PyTorch (cpu, float32)"


def test_plan_engine_name():
    """The kernel route's line names the CUDA kernels only on a CUDA
    device; on the CPU their plain versions, which run float32."""
    cfg = SimConfig(nz=44, nx=64, dz=10.0, dx=10.0, nt=80, dt=0.001,
                    f0=10.0, npml=8)
    row = Survey(src_z=np.array([2]), src_x=np.array([20]),
                 rec_z=np.full(30, 20), rec_x=np.arange(10, 40))
    plan = parallel.try_plan(cfg, row)
    assert cuda_engine.plan_engine_name(plan, device="cuda:0") == \
        "CUDA kernels (elastic_fwd.cu + elastic_bwd.cu), receiver row"
    assert cuda_engine.plan_engine_name(plan, device="cpu") == \
        "plain versions of the CUDA kernels (cpu, float32), receiver row"


def test_try_plan_raises_for_a_rejected_survey():
    """try_plan returns None only for receivers outside the recordable
    range; a survey the kernels reject for another reason raises, so that
    the engine choice never hides it."""
    cfg = SimConfig(nz=44, nx=64, dz=10.0, dx=10.0, nt=80, dt=0.001,
                    f0=10.0, npml=8)
    row = Survey(src_z=np.array([2]), src_x=np.array([20]),
                 rec_z=np.full(30, 20), rec_x=np.arange(10, 40))
    assert parallel.try_plan(cfg, row) is not None
    bad = SimConfig(**{**cfg.__dict__, "das_channel": "eyy"})
    with pytest.raises(ValueError, match="das_channel 'eyy'"):
        parallel.try_plan(bad, row)
    weighted = SimConfig(**{**cfg.__dict__, "das_channel": "weighted"})
    with pytest.raises(ValueError, match="weights"):
        parallel.try_plan(weighted, row)


@pytest.mark.parametrize("engine,device,dtype,want", [
    ("auto", "cpu", F32, "plain"),
    ("xla", "cpu", F32, "plain"),
    ("auto", "cuda", F32, "engine='xla' runs the plain propagator"),
    ("auto", "cuda", F64, "plain"),
    ("xla", "cuda", F32, "plain"),
    ("pallas", "cpu", F32, "engine must be 'auto' or 'xla'"),
])
def test_api_engine_on_a_survey_no_plan_takes(engine, device, dtype, want):
    """ElasticPropagator's engine choice for `corner_survey`: the plain
    propagator on the CPU, on the card only under engine='xla' or in
    float64; engine='auto' in float32 on the card raises before anything
    is put on the device.  On a machine without a card the rows that would
    run on it stop where the first tensor goes there."""
    model, survey, _ = corner_api_problem()
    make = lambda: api.ElasticPropagator(model, survey, device=device,
                                         dtype=dtype, engine=engine)
    if want != "plain":
        with pytest.raises(ValueError, match=want):
            make()
    elif device == "cpu" or torch.cuda.is_available():
        assert make().rs is None
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            make()
