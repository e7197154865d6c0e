"""The port stands alone and never falls back.

* Importing sep2023_tpu_torch (cli, api, the CUDA engine) loads neither jax
  nor sep2023_tpu: the machine with the card has no JAX.
* forward_cuda on tensors that are not on the CPU builds and launches the
  kernel or raises; it never runs the plain version instead.
* The wrapper rejects what the kernel does not take before any pointer is
  passed.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sep2023_tpu_torch.config import SimConfig
from sep2023_tpu_torch.ops import _build, cuda_engine

REPO = Path(__file__).resolve().parents[1]

CFG = SimConfig(nz=24, nx=30, dz=20.0, dx=20.0, nt=12, dt=0.002, f0=10.0,
                npml=4)
RS = cuda_engine.RowSurvey(rec_row=15, rec_x0=5, n_rec=10)


def _inputs(device="cpu", dtype=torch.float32, S=2):
    plane = lambda v: torch.full((CFG.nz, CFG.nx), v, device=device,
                                 dtype=dtype)
    stf = torch.ones((S, CFG.nt), device=device, dtype=dtype)
    return (plane(6e9), plane(6e9), plane(2500.0), stf,
            np.full(S, 2), np.full(S, 10), np.ones(S))


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import sep2023_tpu_torch, sep2023_tpu_torch.cli, "
        "sep2023_tpu_torch.api, sep2023_tpu_torch.ops.cuda_engine, "
        "sep2023_tpu_torch.convert, sep2023_tpu_torch.io\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sep2023_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_forward_cuda_raises_when_build_fails(monkeypatch):
    def broken_build():
        raise RuntimeError("nvcc failed (simulated)")

    def no_plain(*a, **k):
        raise AssertionError("forward_cuda fell back to the plain version")

    monkeypatch.setattr(_build, "_LIB", None)  # as in a fresh process
    monkeypatch.setattr(_build, "build", broken_build)
    monkeypatch.setattr(cuda_engine, "forward_plain", no_plain)
    before = cuda_engine.LAUNCHES
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_engine.forward_cuda(CFG, RS, *_inputs(device="meta"))
    assert cuda_engine.LAUNCHES == before


def test_library_path_keyed_by_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text("// one\n")
    p1 = _build.library_path()
    assert p1 == _build.library_path()
    (tmp_path / "a.cu").write_text("// two\n")
    p2 = _build.library_path()
    assert p1 != p2 and p2.parent == _build.BUILD_DIR
    real = [p.name for p in sorted((REPO / "sep2023_tpu_torch" / "csrc")
                                   .glob("*.cu"))]
    assert "elastic_fwd.cu" in real


@pytest.mark.parametrize("case,exc,match", [
    ("f64", TypeError, "float32"),
    ("weighted", NotImplementedError, "K1-fiber"),
    ("fiber", NotImplementedError, "RowSurvey"),
    ("src_out", ValueError, "src_z outside"),
    ("rec_edge", ValueError, "does not fit"),
    ("stf_shape", ValueError, "stf must be"),
    ("noncontig", ValueError, "contiguous"),
])
def test_forward_cuda_rejects(case, exc, match):
    cfg, rs = CFG, RS
    lam, mu, rho, stf, sz, sx, rxz = _inputs(
        dtype=torch.float64 if case == "f64" else torch.float32)
    if case == "weighted":
        cfg = SimConfig(**{**CFG.__dict__, "das_channel": "weighted"})
    elif case == "fiber":
        rs = None
    elif case == "src_out":
        sz = np.array([2, CFG.nz])
    elif case == "rec_edge":
        rs = cuda_engine.RowSurvey(rec_row=15, rec_x0=0, n_rec=10)  # x-1 < 0
    elif case == "stf_shape":
        stf = stf[:, :-1].contiguous()
    elif case == "noncontig":
        lam = torch.full((CFG.nx, CFG.nz), 6e9).t()
    with pytest.raises(exc, match=match):
        cuda_engine.forward_cuda(cfg, rs, lam, mu, rho, stf, sz, sx, rxz)


def test_check_row_survey():
    assert cuda_engine.check_row_survey(np.full(5, 7), np.arange(3, 8)) == \
        cuda_engine.RowSurvey(7, 3, 5)
    assert cuda_engine.check_row_survey(np.array([7, 8]),
                                        np.array([3, 4])) is None
    assert cuda_engine.check_row_survey(np.array([7, 7]),
                                        np.array([3, 5])) is None
