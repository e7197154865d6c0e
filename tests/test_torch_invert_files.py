"""`invert` with the reference's files on the port, against the JAX package's,
on the CPU in float64 (tests/torch_invert_parity.py): --generate_data,
--resume, --save-mat, --scratch-dir, --para-json (with its `filter` and
if_win entries) and --survey-json (per-trace windows and weights, shot
weights, a ragged spread)."""
import json
import os
import shutil

import numpy as np
import pytest
from scipy.io import loadmat

from sep2023_tpu_torch import io as sio
from sep2023_tpu_torch.config import Survey, sim_config_from_json
from torch_invert_parity import run_both, run_jax, run_port


def _shots(d, survey, nt=80):
    return sio.read_shots_survey(d, survey, nt)


def test_generate_data_matches_jax(tmp_path, capsys):
    """The Shot_* files and the para/survey JSON pair of --generate_data."""
    dp, dj = str(tmp_path / "dp"), str(tmp_path / "dj")
    assert run_port(str(tmp_path / "ep"), ["--data-dir", dp,
                                           "--generate_data"]) is None
    run_jax(str(tmp_path / "ej"), ["--data-dir", dj, "--generate_data"])
    sp = Survey.from_json(os.path.join(dp, "survey_file.json"))
    sj = Survey.from_json(os.path.join(dj, "survey_file.json"))
    for k in ("src_z", "src_x", "rec_z", "rec_x", "src_rxz"):
        np.testing.assert_array_equal(getattr(sp, k), getattr(sj, k))
    cp = sim_config_from_json(os.path.join(dp, "para_file.json"))
    cj = sim_config_from_json(os.path.join(dj, "para_file.json"))
    assert cp == cj and (cp.nt, cp.npml) == (80, 8)
    a, b = _shots(dp, sp), _shots(dj, sj)
    assert a.shape == (3, 4, 28, 80) and np.abs(b).max() > 0
    for c in range(4):  # float32 files of float64 runs
        np.testing.assert_allclose(a[:, c], b[:, c], rtol=0,
                                   atol=1e-6 * np.abs(b[:, c]).max())


def test_resume_matches_jax(tmp_path, monkeypatch, capsys):
    """Two invocations on the same data (the reference's workflow), the
    second with --resume: it starts at the last snapshot, at iteration 0,
    and appends to loss.txt."""
    d = str(tmp_path / "data")
    run_jax(str(tmp_path / "gen"), ["--data-dir", d, "--generate_data"])
    _, ep, ej, _ = run_both(tmp_path, monkeypatch, ["--data-dir", d],
                            tag="r")
    # both resume from the JAX package's snapshot, so that the resumed
    # first misfits can be held to 1e-10 (the two trajectories agree to
    # about 1e-7, loss.txt's bound)
    last = sorted(f for f in os.listdir(os.path.join(ej, "Results"))
                  if f.startswith("model_"))[-1]
    shutil.copy(os.path.join(ej, "Results", last),
                os.path.join(ep, "Results", last))
    capsys.readouterr()
    _, ep, _, first = run_both(tmp_path, monkeypatch,
                               ["--data-dir", d, "--resume"], tag="r")
    assert "resumed from" in capsys.readouterr().out
    h = np.loadtxt(os.path.join(ep, "Results", "loss.txt"), ndmin=2)
    assert h.shape == (4, 2) and h[:, 0].tolist() == [0, 1, 0, 1]
    assert first[-1] <= first[0] and h[2, 1] <= h[0, 1]


def test_save_mat_matches_jax(tmp_path, monkeypatch):
    """--save-mat writes each snapshot as a .mat file too: the port's hold
    its .npz arrays and equal the JAX package's (the gradient of a later
    iterate moves more than the iterate does, hence its looser bound)."""
    _, ep, ej, _ = run_both(tmp_path, monkeypatch, ["--save-mat"])
    rp, rj = os.path.join(ep, "Results"), os.path.join(ej, "Results")
    mats = sorted(f for f in os.listdir(rp) if f.endswith(".mat"))
    assert mats == sorted(f for f in os.listdir(rj) if f.endswith(".mat"))
    assert {"model_0000.mat", "grad_0000.mat", "model_0001.mat"} <= set(mats)
    for f in mats:
        mp, mj = loadmat(os.path.join(rp, f)), loadmat(os.path.join(rj, f))
        with np.load(os.path.join(rp, f.replace(".mat", ".npz"))) as z:
            assert sorted(z.files) == ["rho", "vp", "vs"]
            for k in z.files:
                np.testing.assert_array_equal(mp[k], z[k])
                tol = 1e-4 if f.startswith("grad_") else 1e-6
                np.testing.assert_allclose(
                    mp[k], mj[k], rtol=0, atol=tol * np.abs(mj[k]).max())


def test_scratch_dir_matches_jax(tmp_path, monkeypatch):
    """--scratch-dir writes the final synthetics, the residual (sample 0
    zeroed) and the observed data as Shot_* files, equal to the JAX
    package's."""
    sp, sj = str(tmp_path / "sp"), str(tmp_path / "sj")
    run_both(tmp_path, monkeypatch, [], port_flags=["--scratch-dir", sp],
             jax_flags=["--scratch-dir", sj])
    survey = Survey(src_z=np.ones(3), src_x=np.arange(10, 38, 10),
                    rec_z=np.full(28, 26), rec_x=np.arange(10, 38))
    for name in ("Syn", "Residual", "CondObs"):
        a = _shots(os.path.join(sp, name), survey)
        b = _shots(os.path.join(sj, name), survey)
        assert np.abs(b[:, 3]).max() > 0, name
        for c in range(4):
            np.testing.assert_allclose(a[:, c], b[:, c], rtol=0,
                                       atol=1e-5 * np.abs(b[:, c]).max())
        if name == "Residual":
            assert np.abs(a[..., 0]).max() == 0.0


def test_para_json_matches_jax(tmp_path, monkeypatch, capsys):
    """invert straight off a para_file.json written by --generate_data: its
    grid, survey file and data directory, its `filter` entry as one
    band-passed stage and its if_win window."""
    d = str(tmp_path / "Data")
    run_jax(str(tmp_path / "gen"), ["--data-dir", d, "--generate_data"])
    pf = os.path.join(d, "para_file.json")
    with open(pf) as fp:
        pd = json.load(fp)
    pd.update({"filter": [0.0, 1e-4, 20.0, 60.0], "if_win": True,
               "win_start": 5, "win_end": 75})
    with open(pf, "w") as fp:
        json.dump(pd, fp)
    capsys.readouterr()
    run_both(tmp_path, monkeypatch, ["--para-json", pf])
    out = capsys.readouterr().out
    assert out.count("band-pass from para filter") == 2
    assert out.count("scalar taper window [5, 75] samples") == 2
    assert out.count("loading observed data") == 2


@pytest.mark.parametrize("kind", ["per_trace", "ragged"])
def test_survey_json_matches_jax(tmp_path, monkeypatch, capsys, kind):
    """A reference-schema survey_file.json: per-trace windows and weights
    with per-shot src_weights (squared into the misfit), or per-shot
    spreads of different lengths whose padding the live mask zeroes."""
    sj = str(tmp_path / "survey.json")
    if kind == "per_trace":
        S, R = 3, 28
        rng = np.random.default_rng(4)
        Survey(src_z=np.ones(S), src_x=np.array([10, 20, 30]),
               rec_z=np.full(R, 22), rec_x=np.arange(10, 38),
               win_start=rng.uniform(0, 10, (S, R)).round(),
               win_end=rng.uniform(60, 79, (S, R)).round(),
               trace_weights=rng.uniform(0.5, 1.5, (S, R)),
               src_weights=np.array([1.0, 0.5, 1.0])).to_json(sj)
        said = "per-trace windows/weights active"
    else:
        d = {"nShots": 3}
        for i, (sx, n) in enumerate(((10, 20), (20, 28), (30, 24))):
            d[f"shot{i}"] = {"z_src": 1, "x_src": sx, "nrec": n,
                             "z_rec": [22] * n,
                             "x_rec": list(range(10, 10 + n))}
        with open(sj, "w") as fp:
            json.dump(d, fp)
        said = "incl. ragged live mask"
    capsys.readouterr()
    out, _, _, first = run_both(tmp_path, monkeypatch,
                                ["--survey-json", sj])
    assert capsys.readouterr().out.count(said) == 2
    assert first[0] > 0 and out["misfit"] < first[0]
