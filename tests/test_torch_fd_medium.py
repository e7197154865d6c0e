"""The port's stencils, material fields, CPML profiles, taper, geometry and
numpy copies against the JAX package's functions, in float64 (1e-12)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sep2023_tpu import config as jcfg
from sep2023_tpu import cpml as jcpml
from sep2023_tpu import medium as jmed
from sep2023_tpu import models as jmodels
from sep2023_tpu import parallel as jpar
from sep2023_tpu import survey_tools as jst
from sep2023_tpu.ops import fd as jfd
from sep2023_tpu.ops import signal as jsig
from sep2023_tpu_torch import config as tcfg
from sep2023_tpu_torch import cpml as tcpml
from sep2023_tpu_torch import medium as tmed
from sep2023_tpu_torch import models as tmodels
from sep2023_tpu_torch import parallel as tpar
from sep2023_tpu_torch import survey_tools as tst
from sep2023_tpu_torch.ops import fd as tfd
from sep2023_tpu_torch.ops import signal as tsig

TOL = 1e-12
F64 = torch.float64


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1.0)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("name", ["dz_minus", "dz_plus", "dx_minus",
                                  "dx_plus"])
def test_fd_stencils(name):
    f = np.random.default_rng(0).standard_normal((13, 17))
    _close(getattr(tfd, name)(_t(f)).numpy(),
           getattr(jfd, name)(jnp.asarray(f)))
    # a leading shot axis rides along
    fs = np.random.default_rng(1).standard_normal((3, 13, 17))
    out = getattr(tfd, name)(_t(fs)).numpy()
    for s in range(3):
        _close(out[s], getattr(jfd, name)(jnp.asarray(fs[s])))


def test_update_mask():
    tz, tx = tfd.update_mask(11, 14, 2, 8, 3, 10, device="cpu", dtype=F64)
    jz, jx = jfd.update_mask(11, 14, 2, 8, 3, 10, dtype=jnp.float64)
    assert tz.shape == (11, 1) and tx.shape == (1, 14)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_material_fields():
    rng = np.random.default_rng(2)
    lam = rng.uniform(1e9, 5e9, (12, 15))
    mu = rng.uniform(1e9, 3e9, (12, 15))
    mu[4:7, 5:9] = 0.0          # a fluid pocket: harmonic average guard
    rho = rng.uniform(1800.0, 2600.0, (12, 15))
    t = tmed.material_fields(_t(lam), _t(mu), _t(rho))
    j = jmed.material_fields(jnp.asarray(lam), jnp.asarray(mu),
                             jnp.asarray(rho))
    assert t._fields == j._fields
    for a, b in zip(t, j):
        _close(a.numpy(), b)
    assert (t.ave_mu.numpy()[3:7, 4:9] == 0).all()


def test_medium_pad_and_lambda():
    rng = np.random.default_rng(3)
    vp = rng.uniform(2500.0, 3500.0, (9, 11))
    vs = vp / np.sqrt(3.0)
    rho = rng.uniform(2000.0, 2600.0, (9, 11))
    tm = tmed.Medium(_t(vp), _t(vs), _t(rho))
    jm = jmed.Medium(jnp.asarray(vp), jnp.asarray(vs), jnp.asarray(rho))
    for a, b in zip(tm.to_lame(), jm.to_lame()):
        _close(a.numpy(), b)
    back = tmed.Medium.from_lame(*tm.to_lame())
    _close(back.vp.numpy(), vp)
    _close(tmed.pad_model(_t(vp), 4).numpy(),
           jmed.pad_model(jnp.asarray(vp), 4))
    np.testing.assert_array_equal(tmed.pad_model_np(vp, 4),
                                  jmed.pad_model_np(vp, 4))
    assert tmed.check_lambda(tm.lam) == pytest.approx(
        jmed.check_lambda(jm.lam), rel=TOL)
    with pytest.warns(RuntimeWarning, match="negative Lame"):
        tmed.check_lambda(_t(-np.ones((2, 2))))


@pytest.mark.parametrize("fn", ["cpml_scaled", "cpml_profiles"])
def test_cpml_profiles(fn):
    args = (64, 80, 10, 20.0, 15.0, 0.002, 10.0)
    for dtype in (np.float32, np.float64):
        t = getattr(tcpml, fn)(*args, dtype=dtype)
        j = getattr(jcpml, fn)(*args, dtype=dtype)
        assert t._fields == j._fields
        for a, b in zip(t, j):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("win", [(None, None, 0.001), (10, 90, 0.05),
                                 ([5, 12, 30], [80, 70, 99], 0.02)])
def test_taper_window(win):
    ws, we, ratio = win
    t = tsig.taper_window(120, 0.002, ws, we, ratio=ratio, dtype=F64)
    j = jsig.taper_window(120, 0.002, None if ws is None else np.asarray(ws),
                          None if we is None else np.asarray(we),
                          ratio=ratio, dtype=jnp.float64)
    _close(t.numpy(), j)


def test_survey_to_geoms():
    survey = jcfg.Survey(src_z=np.array([1, 3]), src_x=np.array([5, 9]),
                         rec_z=np.full(6, 7), rec_x=np.arange(2, 8),
                         src_rxz=np.array([1.0, 2.5]))
    tsurvey = tcfg.Survey(src_z=survey.src_z, src_x=survey.src_x,
                          rec_z=survey.rec_z, rec_x=survey.rec_x,
                          src_rxz=survey.src_rxz)
    t = tpar.survey_to_geoms(tsurvey, 10, device="cpu", dtype=F64)
    j = jpar.survey_to_geoms(survey, 10, dtype=jnp.float64)
    assert t._fields == j._fields
    for a, b in zip(t, j):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_models():
    for a, b in zip(tmodels.anomaly_vp_vs_rho(28, 48),
                    jmodels.anomaly_vp_vs_rho(28, 48)):
        np.testing.assert_array_equal(a, b)
    for head in ("vp_vs_rho", "lame_rho", "ip_is_rho", "rock_vrh"):
        t = tmodels.twin_experiment_setup(head, 20, 30)
        j = jmodels.twin_experiment_setup(head, 20, 30)
        for dt_, dj in zip(t[:2], j[:2]):
            assert dt_.keys() == dj.keys()
            for k in dt_:
                np.testing.assert_array_equal(dt_[k], dj[k])
        assert t[2:] == j[2:]
    np.testing.assert_array_equal(tmodels.overthrust_vp(30, 40),
                                  jmodels.overthrust_vp(30, 40))
    # the Gassmann true model of Main-005 (float64, as the JAX tests run)
    t = tmodels.twin_experiment_setup("vp_vs_rho", 20, 30, model="rock")
    j = jmodels.twin_experiment_setup("vp_vs_rho", 20, 30, model="rock")
    for dt_, dj in zip(t[:2], j[:2]):
        assert dt_.keys() == dj.keys()
        for k in dt_:
            np.testing.assert_allclose(dt_[k], dj[k], rtol=1e-14)
    assert t[2].keys() == j[2].keys() and t[3] == j[3]
    for k in t[2]:
        np.testing.assert_allclose(t[2][k], j[2][k], rtol=1e-14)


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_rock_true_model_follows_the_jax_x64_switch(x64):
    """Main-005's Gassmann true model in the run's dtype equals the JAX
    package's under the same x64 setting, bit for bit: without x64 JAX
    takes the two square roots and lam, mu in float32 (the rest numpy
    float64), and the port's float32 run (`invert` without --x64) does the
    same; with x64 both are float64 throughout."""
    import jax
    dtype = F64 if x64 else torch.float32
    with jax.enable_x64(x64):
        j = jmodels.twin_experiment_setup("vp_vs_rho", 20, 30, model="rock")
    t = tmodels.twin_experiment_setup("vp_vs_rho", 20, 30, model="rock",
                                      dtype=dtype)
    for k in ("vp", "vs", "rho"):
        assert t[0][k].dtype == np.float64 and j[0][k].dtype == np.float64
        np.testing.assert_array_equal(t[0][k], j[0][k])
    for k in t[1]:
        np.testing.assert_array_equal(t[1][k], j[1][k])


def test_survey_tools():
    rng = np.random.default_rng(4)
    vp = rng.uniform(2500.0, 3500.0, (20, 30))
    vs = vp / rng.uniform(1.6, 1.9, (20, 30))
    np.testing.assert_array_equal(
        tst.compute_rxz(vp, vs, np.array([1, 10]), np.array([3, 20])),
        jst.compute_rxz(vp, vs, np.array([1, 10]), np.array([3, 20])))
    cfg = tcfg.SimConfig(nz=40, nx=50, dz=20.0, dx=20.0, nt=30, dt=0.002,
                         f0=10.0, npml=10)
    survey = tcfg.Survey(src_z=np.array([1, 1]), src_x=np.array([0, 29]),
                         rec_z=np.full(3, 2), rec_x=np.arange(0, 3))
    with pytest.warns(UserWarning, match="cannot reach"):
        bad = tst.check_reach(cfg, survey, 3000.0)
    assert bad == jst.check_reach(cfg, survey, 3000.0, warn=False) == [1]


def test_config_copy(tmp_path):
    assert (tcfg.C1, tcfg.C2, tcfg.SRC_SCALE) == (jcfg.C1, jcfg.C2,
                                                  jcfg.SRC_SCALE)
    for name in ("ricker", "ricker_integrated", "klauder"):
        np.testing.assert_array_equal(getattr(tcfg, name)(10.0, 300, 0.002),
                                      getattr(jcfg, name)(10.0, 300, 0.002))
    kw = dict(nz=40, nx=50, dz=20.0, dx=15.0, nt=30, dt=0.002, f0=10.0,
              npml=10)
    tc, jc = tcfg.SimConfig(**kw), jcfg.SimConfig(**kw)
    assert tc.courant_number(3000.0) == jc.courant_number(3000.0)
    with pytest.raises(ValueError, match="unstable"):
        tcfg.SimConfig(**{**kw, "dt": 0.01}).check_stability(3000.0)

    # reference-schema JSON: identical files, identical round trip
    sv = dict(src_z=np.array([1, 2]), src_x=np.array([5, 9]),
              rec_z=np.array([[7, 7, 7], [8, 8, 0]]),
              rec_x=np.array([[2, 3, 4], [1, 2, 0]]),
              rec_live=np.array([[1, 1, 1], [1, 1, 0]]),
              src_weights=np.array([1.0, 0.5]))
    paths = {}
    for tag, mod, cfg in (("t", tcfg, tc), ("j", jcfg, jc)):
        s = str(tmp_path / f"{tag}_survey.json")
        p = str(tmp_path / f"{tag}_para.json")
        mod.Survey(**sv).to_json(s)
        mod.sim_config_to_json(cfg, p, "survey.json", "data")
        paths[tag] = (s, p)
    for a, b in zip(paths["t"], paths["j"]):
        assert json.load(open(a)) == json.load(open(b))
    back = tcfg.Survey.from_json(paths["t"][0])
    np.testing.assert_array_equal(back.rec_live, sv["rec_live"])
    assert tcfg.sim_config_from_json(paths["t"][1]) == tc
