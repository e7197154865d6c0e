"""`invert --engine` of the port, the JAX CLI's spelling, and the engine
choice behind it (`cli.resolve_engine`): pallas is the CUDA kernels and
needs --device cuda, float32 and a planned survey; xla is the plain
PyTorch version on whatever device --device names; auto takes the kernels
for float32 on --device cuda and the plain version otherwise, and refuses
a survey the kernels cannot plan, naming --engine xla.  Through `cli.main`
over the six (engine, device) pairs on a machine without a card, where
--device cuda raises as it always has; the runnable pairs stop after
--generate_data and name the plain engine's device and dtype.
"""
import os

import pytest
import torch

from sep2023_tpu_torch import cli
from torch_invert_parity import TINY


@pytest.mark.parametrize("engine,device,raises", [
    ("auto", "cpu", None),
    ("xla", "cpu", None),
    ("pallas", "cpu", (ValueError, "--engine pallas runs on --device cuda")),
    ("auto", "cuda", (RuntimeError, "needs a CUDA device")),
    ("pallas", "cuda", (RuntimeError, "needs a CUDA device")),
    ("xla", "cuda", (RuntimeError, "needs a CUDA device")),
])
def test_engine_follows_device(tmp_path, monkeypatch, capsys, engine, device,
                               raises):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["invert", *TINY, "--engine", engine, "--device", device,
            "--exp-name", str(tmp_path), "--generate_data", "--data-dir",
            str(tmp_path / "data")]
    if raises is not None:
        exc, match = raises
        with pytest.raises(exc, match=match):
            cli.main(argv)
        return
    assert cli.main(argv) is None
    assert "engine: plain PyTorch (cpu, float64)" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "data" / "Shot_ett0.bin")


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("engine,device,dtype,planned,want", [
    ("auto", "cuda", F32, True, "kernels"),
    ("auto", "cuda", F32, False, "--engine xla runs it"),
    ("auto", "cuda", F64, True, "plain"),
    ("auto", "cuda", F64, False, "plain"),
    ("auto", "cpu", F32, True, "plain"),
    ("auto", "cpu", F64, False, "plain"),
    ("xla", "cuda", F32, True, "plain"),
    ("xla", "cuda", F64, False, "plain"),
    ("xla", "cpu", F64, True, "plain"),
    ("pallas", "cuda", F32, True, "kernels"),
    ("pallas", "cpu", F32, True, "runs on --device cuda"),
    ("pallas", "cuda", F64, True, "computes in float32"),
    ("pallas", "cuda", F32, False, "--engine xla runs it"),
])
def test_resolve_engine(engine, device, dtype, planned, want):
    """Every row of the engine table: the kernels, the plain version on the
    device asked for, or a ValueError naming the way out."""
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

