"""`invert --engine` of the port, the JAX CLI's spelling, held to
--device over its six pairs: auto follows --device, pallas (the CUDA
kernels) needs --device cuda and xla (the plain version) --device cpu; a
pair that disagrees raises, and on a machine without a card --device cuda
raises as it always has.  The runnable pairs stop after --generate_data.
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
    ("xla", "cuda", (ValueError, "--engine xla runs on --device cpu")),
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
    assert "engine: plain PyTorch (CPU)" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "data" / "Shot_ett0.bin")
