"""The port's `forward` command and ElasticPropagator against the JAX
package's, on the CPU.

nt=120 at the 28x48 grid lets the direct wave reach the receiver row
(z=22, 21 rows below the sources), so the Shot files carry arrivals.
"""
import json
import os

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
from sep2023_tpu_torch.ops import cuda_engine

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


def test_forward_cli_acoustic_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="M9"):
        tcli.main(ARGS + ["--device", "cpu", "--physics", "acoustic"])


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
    """A row survey runs forward_cuda (its plain version on the CPU); any
    other layout runs the plain propagator."""
    rec_z = np.full(20, 16) if layout == "row" else np.repeat([16, 18], 10)
    sv = dict(src_z=np.array([2, 2]), src_x=np.array([12, 40]), rec_z=rec_z,
              rec_x=np.arange(14, 34))
    ref = japi.ElasticPropagator(model, Survey(**sv)).apply_forward()
    prop = tapi.ElasticPropagator(tapi.Model(**model.__dict__),
                                  tcfg.Survey(**sv), device="cpu")
    assert (prop.rs is None) == (layout != "row")
    out = prop.apply_forward()
    assert out.shape == ref.shape == (2, 4, 20, 160)
    assert np.abs(ref[:, 3]).max() > 1e-3
    for c in range(4):
        scale = np.abs(ref[:, c]).max()
        assert np.abs(out[:, c] - ref[:, c]).max() / scale < 2e-5, c
    # an override model goes through the same path
    over = prop.apply_forward(vp=np.full((36, 52), 3100.0))
    assert np.isfinite(over).all() and not np.allclose(over, out)


@pytest.mark.parametrize("case,match", [
    ("two_rows", "K1-fiber"),
    ("ragged", "K1-fiber"),
    ("f64", "float32"),
])
def test_apply_forward_off_cpu_raises(model, monkeypatch, case, match):
    """Off the CPU, what the kernel cannot take raises: it never runs the
    plain propagator on the device instead."""
    def no_plain(*a, **k):
        raise AssertionError("ElasticPropagator ran the plain propagator")

    monkeypatch.setattr(tapi.propagator, "propagate_shots", no_plain)
    sv = dict(src_z=np.array([2, 2]), src_x=np.array([12, 40]),
              rec_z=np.full(20, 16), rec_x=np.arange(14, 34))
    if case == "two_rows":
        sv["rec_z"] = np.repeat([16, 18], 10)
    elif case == "ragged":
        sv["rec_z"] = np.full((2, 20), 16)
        sv["rec_x"] = np.stack([np.arange(14, 34), np.arange(15, 35)])
    dtype = torch.float64 if case == "f64" else torch.float32
    with pytest.raises(NotImplementedError, match=match):
        tapi.ElasticPropagator(tapi.Model(**model.__dict__),
                               tcfg.Survey(**sv), device="meta", dtype=dtype)
