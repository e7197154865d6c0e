"""The port's invert path against the JAX package's, on the CPU.

* medium.resize_and_pad, the five non-rock heads (apply and gradient),
  misfit.l2_misfit: the JAX functions on the same numpy inputs, float64.
* parallel: the chunked gradient accumulator equals the unchunked loss and
  gives the data zero gradients; auto_shot_chunk sizes chunks by the
  port's flat strip layout.
* cli invert --device cpu --x64 at the size of tests/test_cli.py's TINY:
  its first misfit equals the JAX package's `invert` on the same arguments
  to 1e-10, and its loss.txt trajectory to 1e-6; --generate_data, then a
  run that loads the written data; every option that is not ported raises
  NotImplementedError naming its ROADMAP item.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sep2023_tpu import cli as jcli
from sep2023_tpu import heads as jheads
from sep2023_tpu import medium as jmedium
from sep2023_tpu import optimize as joptimize
from sep2023_tpu.ops import misfit as jmf
from sep2023_tpu_torch import cli, heads, medium, models, optimize, parallel
from sep2023_tpu_torch import propagator
from sep2023_tpu_torch.config import SimConfig, Survey, ricker
from sep2023_tpu_torch.ops import misfit as tmf

TINY = ["--nz", "28", "--nx", "48", "--nt", "80", "--npml", "8",
        "--niter", "2", "--x64"]
HEAD_NAMES = ["vp_vs_rho", "lame_rho", "ip_is_rho", "vp_vs_ip", "vp_vs_is"]


def _f64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("shape", [(20, 30), (7, 12)],
                         ids=["identity", "upsample"])
def test_resize_and_pad_matches_jax(shape):
    """Bilinear with half-pixel centres (align_corners=False), then an edge
    pad: equal to jax.image.resize 'linear' + pad when the size is kept or
    grown (shrinking differs: jax antialiases)."""
    a = np.random.default_rng(1).standard_normal(shape)
    ref = np.asarray(jmedium.resize_and_pad(jnp.asarray(a), 20, 30, 6))
    out = medium.resize_and_pad(_f64(a), 20, 30, 6).numpy()
    assert out.shape == (32, 42)
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", HEAD_NAMES)
def test_head_matches_jax(name):
    """apply() and its gradient under a random cotangent, float64, with the
    reference's blend mask and the twin experiment's initial model."""
    nz, nx, npml = 20, 30, 6
    grid = SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0,
                     nt=10, dt=0.002, f0=10.0, npml=npml).grid
    _, init, bounds, names = models.twin_experiment_setup(name, nz, nx)
    rng = np.random.default_rng(5)
    params = {k: np.asarray(v) * (1 + 0.01 * rng.standard_normal(v.shape))
              for k, v in init.items()}
    cts = [rng.standard_normal(grid.shape) for _ in range(3)]

    jh = jheads.HEADS[name](grid, init, mask=jheads.default_mask(grid, 4),
                            bounds=bounds)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out_j, pull = jax.vjp(jh.apply, jp)
    (g_j,) = pull(tuple(jnp.asarray(c) for c in cts))

    th = heads.HEADS[name](grid, init, mask=heads.default_mask(grid, 4),
                           bounds=bounds)
    assert th.param_names == tuple(names) == jh.param_names
    tp = {k: _f64(v).requires_grad_() for k, v in params.items()}
    out_t = th.apply(tp)
    g_t = torch.autograd.grad(out_t, [tp[k] for k in names],
                              [_f64(c) for c in cts])
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-12)
    for k, g in zip(names, g_t):
        b = np.asarray(g_j[k])
        assert np.abs(g.numpy() - b).max() <= 1e-12 * np.abs(b).max(), k


@pytest.mark.parametrize("name", ["rock_vrh", "rock_gassmann"])
def test_rock_heads_raise(name):
    grid = SimConfig(nz=20, nx=30, dz=20.0, dx=20.0, nt=10, dt=0.002,
                     f0=10.0, npml=4).grid
    with pytest.raises(NotImplementedError, match="M4"):
        heads.HEADS[name](grid, {})


@pytest.mark.parametrize("channels", [("ett",), ("pr", "vx", "vz")])
def test_l2_misfit_matches_jax(channels):
    rng = np.random.default_rng(2)
    obs, syn = rng.standard_normal((2, 3, 4, 5, 30))
    ref = float(jmf.l2_misfit(jnp.asarray(obs), jnp.asarray(syn), channels))
    out = float(tmf.l2_misfit(_f64(obs), _f64(syn), channels))
    assert out == pytest.approx(ref, rel=1e-14)
    one = float(tmf.l2_misfit(_f64(obs[1]), _f64(syn[1]), channels))
    assert one == pytest.approx(float(jmf.l2_misfit(
        jnp.asarray(obs[1]), jnp.asarray(syn[1]), channels)), rel=1e-14)
    r = tmf.residual(_f64(obs), _f64(syn))
    assert float(r[..., 0].abs().max()) == 0.0


def _chunk_problem():
    npml = 6
    cfg = SimConfig(nz=24 + 2 * npml, nx=32 + 2 * npml, dz=20.0, dx=20.0,
                    nt=60, dt=0.002, f0=10.0, npml=npml)
    survey = Survey(src_z=np.ones(3), src_x=np.array([6, 16, 26]),
                    rec_z=np.full(20, 10), rec_x=np.arange(6, 26))
    geoms = parallel.survey_to_geoms(survey, npml, device="cpu",
                                     dtype=torch.float64)
    vp = np.full((cfg.nz, cfg.nx), 3000.0)
    vp[14:20, 16:28] += 200.0
    rho = np.full((cfg.nz, cfg.nx), 2500.0)
    lam, mu = (vp ** 2 - 2 * (vp / np.sqrt(3)) ** 2) * rho, vp ** 2 / 3 * rho
    stf = np.stack([ricker(10.0, cfg.nt, cfg.dt) * (1 + 0.1 * s)
                    for s in range(3)])
    m = [_f64(a) for a in (lam, mu, rho)]
    obs = propagator.propagate_ad(cfg, m[0] * 1.02, *m[1:], _f64(stf),
                                  geoms).detach()
    return cfg, geoms, m, _f64(stf), obs


def test_chunked_sum_equals_unchunked():
    """Chunks of 2 over 3 shots (a ragged tail): value and model/stf
    gradients equal the unchunked loss to 1e-6; the data get zeros."""
    cfg, geoms, m, stf, obs = _chunk_problem()
    w = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)

    def run(chunk):
        ps = [a.clone().requires_grad_() for a in (*m, stf)]
        o = obs.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        loss = parallel.make_local_misfit(cfg, shot_chunk=chunk)(
            *ps, geoms, o, ww)
        return loss.detach(), torch.autograd.grad(loss, [*ps, o, ww])

    l0, g0 = run(0)
    l2, g2 = run(2)
    assert float(l2) == pytest.approx(float(l0), rel=1e-6) and float(l0) > 0
    for a, b in zip(g2[:4], g0[:4]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert float(g0[4].abs().max()) > 0          # unchunked: differentiable
    assert float(g2[4].abs().max()) == 0.0       # chunked: data get zeros
    assert float(g2[5].abs().max()) == 0.0


def test_auto_shot_chunk_port_layout():
    """The port keeps (nt-1) x 5 fields x 2 L (nz + nx) floats a shot: no
    128-lane padding.  129 MB a shot at the reference 165x265, nt=1501."""
    cfg = SimConfig(nz=165, nx=265, dz=20.0, dx=20.0, nt=1501, dt=0.002,
                    f0=10.0, npml=32)
    per = parallel.strip_bytes_per_shot(cfg)
    assert per == 1500 * 5 * 2 * 5 * (165 + 265) * 4 == 129_000_000
    assert parallel.strip_bytes_per_shot(cfg, itemsize=8) == 2 * per
    # a chunk is sized by the strips and the 44 state planes a shot
    state = parallel.state_bytes_per_shot(cfg)
    assert state == 44 * 165 * 265 * 4
    both = per + state
    assert parallel.auto_shot_chunk(cfg, 19, budget_bytes=19 * both) == 0
    assert parallel.auto_shot_chunk(cfg, 19, budget_bytes=19 * per) == 17
    assert parallel.auto_shot_chunk(cfg, 19, budget_bytes=5 * both + 1) == 5
    assert parallel.auto_shot_chunk(cfg, 19, budget_bytes=per // 2) == 1
    assert parallel.hbm_budget_bytes("cpu") == parallel.FALLBACK_BUDGET_BYTES
    assert parallel.auto_shot_chunk(cfg, 19, device="cpu") == 0  # 2.45 GB


def _first_misfit(module, monkeypatch):
    """Record the misfit at the starting point of every lbfgsb call."""
    seen = []
    real = module.lbfgsb

    def spy(obj, *a, **k):
        seen.append(obj.fun(obj.x0))
        return real(obj, *a, **k)

    monkeypatch.setattr(module, "lbfgsb", spy)
    return seen


def _hist(exp):
    return np.loadtxt(os.path.join(exp, "Results", "loss.txt"), ndmin=2)


def test_invert_matches_jax_cli(tmp_path, monkeypatch):
    port_first = _first_misfit(optimize, monkeypatch)
    jax_first = _first_misfit(joptimize, monkeypatch)
    ep, ej = str(tmp_path / "port"), str(tmp_path / "jax")
    out = cli.main(["invert", *TINY, "--device", "cpu", "--exp-name", ep])
    jcli.main(["invert", *TINY, "--n-devices", "1", "--exp-name", ej])
    assert port_first[0] == pytest.approx(jax_first[0], rel=1e-10)
    hp, hj = _hist(ep), _hist(ej)
    assert hp.shape == hj.shape == (2, 2)
    np.testing.assert_allclose(hp, hj, rtol=1e-6)
    assert hp[-1, 1] < hp[0, 1] < port_first[0]
    assert out["nit"] == 2 and out["shot_chunk"] == 0
    for stem in ("model_0000", "grad_0001"):
        with np.load(os.path.join(ep, "Results", f"{stem}.npz")) as z:
            assert sorted(z.files) == ["rho", "vp", "vs"]
            assert z["vp"].shape == (28, 48)


def test_invert_generate_then_load(tmp_path, capsys):
    data = str(tmp_path / "data")
    assert cli.main(["invert", *TINY, "--device", "cpu", "--data-dir", data,
                     "--exp-name", str(tmp_path / "gen"),
                     "--generate_data"]) is None
    assert os.path.exists(os.path.join(data, "Shot_ett0.bin"))
    assert os.path.exists(os.path.join(data, "para_file.json"))
    capsys.readouterr()
    loaded = cli.main(["invert", *TINY, "--device", "cpu", "--data-dir",
                       data, "--exp-name", str(tmp_path / "a")])
    assert "loading observed data" in capsys.readouterr().out
    fresh = cli.main(["invert", *TINY, "--device", "cpu", "--exp-name",
                      str(tmp_path / "b")])
    # the Shot files hold float32: the loaded run is close, not equal
    assert loaded["misfit"] == pytest.approx(fresh["misfit"], rel=1e-3)


@pytest.mark.parametrize("flags,item", [
    (["--misfit", "xcorr"], "M3"),
    (["--energy-weights"], "M3"),
    (["--multiscale"], "M3"),
    (["--bands", "0,1,2,3"], "M3"),
    (["--win", "0,50"], "M3"),
    (["--src-update"], "M3"),
    (["--save-mat"], "M5"),
    (["--invert-stf"], "M7"),
    (["--resume"], "M7"),
    (["--para-json", "p.json"], "M7"),
    (["--survey-json", "s.json"], "M7"),
    (["--scratch-dir", "d"], "M7"),
    (["--n-devices", "2"], "M10"),
    (["--optimizer", "ondevice"], "M11"),
    (["--model", "rock"], "M4"),
    (["--head", "rock_vrh", "--model", "rock"], "M4"),
])
def test_unported_invert_options_raise(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["invert", *TINY, "--device", "cpu", "--exp-name",
                  str(tmp_path), *flags])


def test_invert_x64_needs_the_cpu(tmp_path):
    with pytest.raises((NotImplementedError, RuntimeError)):
        cli.main(["invert", *TINY, "--device", "cuda", "--exp-name",
                  str(tmp_path)])
