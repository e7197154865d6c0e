"""A survey no kernel plan takes, and `--engine pallas` on the CPU, against
the JAX package, on the CPU.  The survey is a receiver row and two corners
of the padded grid: the JAX CLI runs it on its XLA engine under every
--engine, the port on its plain PyTorch version with --device cpu (on the
card under --engine xla, where auto and pallas raise).  (a) `invert
--x64 --device cpu` against the JAX CLI's `invert --x64` on TINY (first
misfit to 1e-10, loss.txt to 1e-6); (b) ElasticPropagator in float64
against the JAX api (data to 1e-10 of the max, misfit to 1e-10, each
gradient to 1e-8 of its max); (c) `invert --engine pallas --device cpu
--generate_data` in float32 on the test row survey, which takes the kernel
route's plain versions: bit for bit the data of --engine auto (the plain
version), and within 1e-5 of each shot's max of the JAX CLI's --engine
pallas data (its Pallas kernels in interpret mode).
"""
import numpy as np
import pytest
import torch

from sep2023_tpu import api as japi
from sep2023_tpu import cli as jcli
from sep2023_tpu.config import Survey as JSurvey
from sep2023_tpu_torch import api, cli, parallel
from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch.config import Survey
from sep2023_tpu_torch.testing import corner_api_problem, corner_survey
from torch_invert_parity import TINY, run_both
from torch_threads import one_thread  # noqa: F401  (autouse)

NT = 80


def jax_survey(sv):
    return JSurvey(src_z=sv.src_z, src_x=sv.src_x, rec_z=sv.rec_z,
                   rec_x=sv.rec_x)


def test_corner_survey_has_no_plan():
    model, survey, _ = corner_api_problem()
    prop = api.ElasticPropagator(model, survey, device="cpu")
    assert parallel.try_plan(prop.cfg, survey) is None and prop.rs is None


def test_invert_unplanned_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """(a): the port's plain version on the CPU against the JAX CLI's XLA
    engine, each naming its engine."""
    path = str(tmp_path / "corners.json")
    corner_survey().to_json(path)
    run_both(tmp_path, monkeypatch, ["--survey-json", path])
    out = capsys.readouterr().out
    assert "engine: plain PyTorch (cpu, float64)" in out
    assert "engine: XLA" in out


def test_api_unplanned_matches_jax():
    """(b): ElasticPropagator(dtype=torch.float64, device='cpu') on the
    corner survey against the JAX api's apply_forward and apply_gradient."""
    model, survey, init = corner_api_problem()
    prop = api.ElasticPropagator(model, survey, device="cpu",
                                 dtype=torch.float64)
    assert prop.rs is None
    jmodel = lambda m: japi.Model(**m.__dict__)
    jprop = japi.ElasticPropagator(jmodel(model), jax_survey(survey),
                                   dtype=np.float64)
    obs, obs_j = prop.apply_forward(), np.asarray(jprop.apply_forward())
    assert obs.shape == obs_j.shape == (3, 4, 30, NT)
    assert np.abs(obs_j).max() > 0
    assert np.abs(obs - obs_j).max() <= 1e-10 * np.abs(obs_j).max()
    out = prop.apply_gradient(init, obs)
    ref = jprop.apply_gradient(jmodel(init), obs, n_devices=1)
    assert out["misfit"] > 0
    assert out["misfit"] == pytest.approx(ref["misfit"], rel=1e-10)
    for k in ("grad_vp", "grad_vs", "grad_rho", "grad_stf"):
        a, b = out[k], np.asarray(ref[k])
        assert a.shape == b.shape and np.abs(b).max() > 0, k
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), k


def test_engine_pallas_on_the_cpu(tmp_path, capsys):
    """(c): --engine pallas --device cpu runs the kernels' plain versions
    (its engine line says so), bit for bit --engine auto's data, and
    within 1e-5 of each shot's max of the JAX CLI's --engine pallas."""
    f32 = [a for a in TINY if a != "--x64"]

    def data(run, tag, *flags):
        d = str(tmp_path / tag)
        run(["invert", *f32, *flags, "--exp-name", d, "--generate_data",
             "--data-dir", d])
        survey = Survey.from_json(f"{d}/survey_file.json")
        return sio.read_shots_survey(d, survey, NT)

    pallas = data(cli.main, "pallas", "--engine", "pallas", "--device", "cpu")
    assert ("engine: plain versions of the CUDA kernels (cpu, float32), "
            "receiver row") in capsys.readouterr().out
    auto = data(cli.main, "auto", "--device", "cpu")
    assert "engine: plain PyTorch (cpu, float32)" in capsys.readouterr().out
    jax = data(jcli.main, "jax", "--engine", "pallas", "--n-devices", "1")
    assert "engine: fused Pallas" in capsys.readouterr().out
    assert pallas.shape == auto.shape == jax.shape
    assert np.array_equal(pallas, auto)
    for s in range(jax.shape[0]):
        ett, ett_j = pallas[s, 3], jax[s, 3]
        assert np.abs(ett_j).max() > 0
        assert np.abs(ett - ett_j).max() <= 1e-5 * np.abs(ett_j).max(), s
