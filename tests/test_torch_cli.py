"""The port's `forward` and `rtm` commands and ElasticPropagator against the
JAX package's, on the CPU.

nt=120 at the 28x48 grid lets the direct wave reach the receiver row
(z=22, 21 rows below the sources), so the Shot files carry arrivals.
`forward --physics acoustic` writes Shot files within 1e-5 of each
channel's max of the JAX CLI's, ett zero.  `rtm --device cpu --x64` at a
30x44 grid (3 shots, reflector at z=20, nt=220 so that its reflection
returns to the receivers) writes the JAX CLI's .npz keys with every image
array within 1e-8 of its max and prints the same peak row, for both
physics.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from sep2023_tpu import api as japi
from sep2023_tpu import cli as jcli
from sep2023_tpu.config import Survey
from sep2023_tpu_torch import api as tapi
from sep2023_tpu_torch import cli as tcli
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import io as tio
from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine

ARGS = ["forward", "--nz", "28", "--nx", "48", "--nt", "120", "--npml", "8",
        "--data-dir", "data"]
N_SHOTS, N_REC, NT = 3, 28, 120


def _run(cli_main, path, argv, monkeypatch):
    path.mkdir()
    monkeypatch.chdir(path)
    cli_main(argv)
    return path / "data"


def test_forward_cli_matches_jax(tmp_path, monkeypatch):
    jdir = _run(jcli.main, tmp_path / "jax", ARGS, monkeypatch)
    before = cuda_engine.LAUNCHES
    tdir = _run(tcli.main, tmp_path / "torch", ARGS + ["--device", "cpu"],
                monkeypatch)
    assert cuda_engine.LAUNCHES == before

    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("para_file.json", "survey_file.json"):
        assert (json.loads((tdir / name).read_text())
                == json.loads((jdir / name).read_text()))
    ref = tio.read_shots(str(jdir), N_SHOTS, N_REC, NT)
    out = tio.read_shots(str(tdir), N_SHOTS, N_REC, NT)
    assert np.abs(ref[:, 3]).max() > 1e-3   # the receivers saw the wave
    for c in range(4):
        scale = np.abs(ref[:, c]).max()
        assert np.abs(out[:, c] - ref[:, c]).max() / scale < 2e-5, c


def test_forward_cli_acoustic_not_ported(tmp_path, monkeypatch, capsys):
    """The acoustic forward is ported (the name dates from when it raised):
    on the CPU it runs the plain propagator, says so, launches nothing and
    returns (S, 3, R, nt) data with arrivals."""
    monkeypatch.chdir(tmp_path)
    before = (cuda_acoustic.LAUNCHES_AC,
              cuda_engine.PLAIN_CALLS["forward_plain_acoustic"])
    data = tcli.main(ARGS[:-2] + ["--device", "cpu", "--physics", "acoustic"])
    assert cuda_acoustic.LAUNCHES_AC == before[0]
    assert cuda_engine.PLAIN_CALLS["forward_plain_acoustic"] == before[1] + 1
    assert data.shape == (N_SHOTS, 3, N_REC, NT)
    assert float(data.abs().max()) > 1e-3
    out = capsys.readouterr().out
    assert "engine: plain PyTorch (acoustic, CPU)" in out
    assert f"acoustic forward: {N_SHOTS} shots in" in out
    assert not os.listdir(tmp_path)     # no --data-dir, no files


def test_forward_cli_acoustic_matches_jax(tmp_path, monkeypatch):
    argv = ARGS + ["--physics", "acoustic"]
    jdir = _run(jcli.main, tmp_path / "jax", argv, monkeypatch)
    tdir = _run(tcli.main, tmp_path / "torch", argv + ["--device", "cpu"],
                monkeypatch)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("para_file.json", "survey_file.json"):
        assert (json.loads((tdir / name).read_text())
                == json.loads((jdir / name).read_text()))
    ref = tio.read_shots(str(jdir), N_SHOTS, N_REC, NT)
    out = tio.read_shots(str(tdir), N_SHOTS, N_REC, NT)
    assert (out[:, 3] == 0).all() and (ref[:, 3] == 0).all()
    for c in range(3):
        scale = np.abs(ref[:, c]).max()
        assert scale > 1e-3                 # the receivers saw the wave
        assert np.abs(out[:, c] - ref[:, c]).max() / scale < 1e-5, c


RTM_ARGS = ["rtm", "--nz", "30", "--nx", "44", "--nt", "220", "--npml", "8",
            "--x64", "--out", "img.npz"]


@pytest.mark.parametrize("physics", ["acoustic", "elastic"])
def test_rtm_cli_matches_jax(tmp_path, monkeypatch, capsys, physics):
    argv = RTM_ARGS + ["--physics", physics]
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jcli.main(argv)
    jout = capsys.readouterr().out
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "torch")
    launches = (cuda_engine.LAUNCHES, cuda_acoustic.LAUNCHES_AC)
    img, illum, peak = tcli.main(argv + ["--device", "cpu"])
    assert (cuda_engine.LAUNCHES, cuda_acoustic.LAUNCHES_AC) == launches
    tout = capsys.readouterr().out
    line = re.compile(r"reflector at z=20, muted-image peak at z=(\d+)")
    assert line.search(jout) and line.search(tout)
    assert line.search(tout).group(1) == line.search(jout).group(1) == \
        str(peak)
    assert f"rtm ({physics}, " in tout
    ref = np.load(tmp_path / "jax" / "img.npz")
    out = np.load(tmp_path / "torch" / "img.npz")
    assert sorted(out.files) == sorted(ref.files) == sorted(
        ["image", "image_muted", "illumination", "image_compensated",
         "vp_true", "vp_background", "z_reflector"])
    assert out["image"].dtype == np.float64
    for key in ("image", "image_muted", "illumination", "image_compensated"):
        scale = np.abs(ref[key]).max()
        assert scale > 0 and np.isfinite(out[key]).all()
        assert np.abs(out[key] - ref[key]).max() / scale < 1e-8, key
    for key in ("vp_true", "vp_background", "z_reflector"):
        np.testing.assert_array_equal(out[key], ref[key])
    np.testing.assert_array_equal(out["image"], img)
    np.testing.assert_array_equal(out["illumination"], illum)
    if physics == "acoustic":   # at this size only the acoustic image does
        assert abs(peak - 20) <= 6      # light the reflector up


def test_rtm_cli_rejects(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tcli.main(RTM_ARGS[:-3])
    with pytest.raises(SystemExit, match="unknown channel"):
        tcli.main(RTM_ARGS + ["--device", "cpu", "--physics", "elastic",
                              "--channels", "exx"])
    assert not os.listdir(tmp_path)


def test_shot_io_round_trip(tmp_path):
    data = np.random.default_rng(3).standard_normal((2, 4, 5, 7))
    tio.write_shots(str(tmp_path), data)
    back = tio.read_shots(str(tmp_path), 2, 5, 7)
    np.testing.assert_array_equal(back, data.astype(np.float32))


@pytest.fixture(scope="module")
def model():
    nz, nx = 36, 52
    vp = np.full((nz, nx), 3000.0)
    vp[20:28, 20:36] += 250.0
    return japi.Model(nx=nx, nz=nz, dx=20.0, dz=20.0, nt=160, dt=0.002,
                      nPml=10, vp=vp, vs=vp / np.sqrt(3.0),
                      rho=np.full((nz, nx), 2500.0))


@pytest.mark.parametrize("layout", ["row", "two_rows"])
def test_apply_forward_matches_jax(model, layout):
    """A row survey plans as a RowSurvey, a two-row spread as point
    receivers; both run the engine (its plain versions on the CPU)."""
    rec_z = np.full(20, 16) if layout == "row" else np.repeat([16, 18], 10)
    sv = dict(src_z=np.array([2, 2]), src_x=np.array([12, 40]), rec_z=rec_z,
              rec_x=np.arange(14, 34))
    ref = japi.ElasticPropagator(model, Survey(**sv)).apply_forward()
    prop = tapi.ElasticPropagator(tapi.Model(**model.__dict__),
                                  tcfg.Survey(**sv), device="cpu")
    assert isinstance(prop.rs, cuda_engine.RowSurvey if layout == "row"
                      else cuda_engine.FiberSurvey)
    calls = cuda_engine.PLAIN_CALLS["forward_plain"]
    out = prop.apply_forward()
    assert cuda_engine.PLAIN_CALLS["forward_plain"] == calls + 1
    assert out.shape == ref.shape == (2, 4, 20, 160)
    assert np.abs(ref[:, 3]).max() > 1e-3
    for c in range(4):
        scale = np.abs(ref[:, c]).max()
        assert np.abs(out[:, c] - ref[:, c]).max() / scale < 2e-5, c
    # an override model goes through the same path
    over = prop.apply_forward(vp=np.full((36, 52), 3100.0))
    assert np.isfinite(over).all() and not np.allclose(over, out)


@pytest.mark.parametrize("case,exc,match", [
    ("two_rows", RuntimeError, "simulated"),
    ("ragged", RuntimeError, "simulated"),
    ("f64", AssertionError, "on meta in float64"),
])
def test_apply_forward_off_cpu_raises(model, monkeypatch, case, exc, match):
    """Off the CPU a two-row and a ragged survey plan as point receivers
    and reach the kernel build (made to fail here); neither runs the plain
    propagator on the device instead.  Float64 runs the plain propagator on
    the device it was given (the JAX API's XLA path), not on the CPU."""
    from sep2023_tpu_torch import parallel, propagator
    from sep2023_tpu_torch.ops import _build

    def broken_build():
        raise RuntimeError("nvcc failed (simulated)")

    def no_plain(cfg, lam, *a, **k):
        if lam.dtype == torch.float64:
            raise AssertionError(f"the plain propagator on {lam.device.type} "
                                 "in float64")
        raise AssertionError("ElasticPropagator ran the plain propagator")

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", broken_build)
    monkeypatch.setattr(propagator, "propagate_shots", no_plain)
    sv = dict(src_z=np.array([2, 2]), src_x=np.array([12, 40]),
              rec_z=np.full(20, 16), rec_x=np.arange(14, 34))
    if case == "two_rows":
        sv["rec_z"] = np.repeat([16, 18], 10)
    elif case == "ragged":
        sv["rec_z"] = np.stack([np.full(20, 16), np.full(20, 18)])
        sv["rec_x"] = np.stack([np.arange(14, 34), np.arange(15, 35)])
    dtype = torch.float64 if case == "f64" else torch.float32
    with pytest.raises(exc, match=match):
        prop = tapi.ElasticPropagator(tapi.Model(**model.__dict__),
                                      tcfg.Survey(**sv), device="meta",
                                      dtype=dtype)
        if case == "f64":
            assert prop.rs is None
            prop.apply_forward()
        assert isinstance(prop.rs, cuda_engine.FiberSurvey)
        assert parallel._cuda_plan(prop.cfg, prop.survey)[0].rs == prop.rs
        prop.apply_forward()
