"""`invert` with the reference's data conditioning, misfits and stage loop on
the port, against the JAX package's, on the CPU in float64
(tests/torch_invert_parity.py): --misfit xcorr, --energy-weights, --win,
--invert-stf, --multiscale, --bands and --src-update."""
import os

import numpy as np
import pytest

from torch_invert_parity import run_both

# two band-pass stages with energy at TINY's nt=80, dt=2 ms (6.25 Hz bins)
BANDS = "0,1e-4,10,30;0,1e-4,20,60"


@pytest.mark.parametrize("flags,said", [
    (["--misfit", "xcorr"], None),
    (["--energy-weights"], "per-trace energy weights computed"),
    (["--win", "10,70"], "scalar taper window [10, 70] samples"),
    (["--energy-weights", "--win", "10,70"],
     "per-trace windows/weights active"),
], ids=["xcorr", "energy_weights", "win", "energy_weights_win"])
def test_conditioned_invert_matches_jax(tmp_path, monkeypatch, capsys,
                                        flags, said):
    out, _, _, first = run_both(tmp_path, monkeypatch, flags)
    assert first[0] > 0 and out["misfit"] < first[0]
    if said:
        assert said in capsys.readouterr().out


def test_invert_stf_matches_jax(tmp_path, monkeypatch):
    """--invert-stf: the wavelets join the parameters without bounds; the
    first iterate's model and gradient snapshots equal the JAX package's."""
    out, ep, ej, first = run_both(tmp_path, monkeypatch, ["--invert-stf"])
    assert out["misfit"] < first[0]
    for stem in ("model_0000", "grad_0000"):
        with np.load(os.path.join(ep, "Results", f"{stem}.npz")) as p, \
                np.load(os.path.join(ej, "Results", f"{stem}.npz")) as j:
            assert sorted(p.files) == sorted(j.files) == [
                "rho", "stf", "vp", "vs"]
            assert p["stf"].shape == (3, 80)
            for k in p.files:
                np.testing.assert_allclose(
                    p[k], j[k], rtol=0, atol=1e-8 * np.abs(j[k]).max())


@pytest.mark.parametrize("flags,stages", [
    (["--multiscale"], 6),
    (["--bands", BANDS], 2),
    (["--bands", BANDS, "--src-update"], 2),
], ids=["multiscale", "bands", "bands_src_update"])
def test_stage_loop_matches_jax(tmp_path, monkeypatch, capsys, flags,
                                stages):
    """One L-BFGS-B run a stage (niter 2 // stages iterations, at least 1),
    loss.txt continued across stages; --src-update re-estimates the
    wavelets from the current model at the start of every stage."""
    out, ep, _, first = run_both(tmp_path, monkeypatch, flags)
    said = capsys.readouterr().out
    assert len(first) == stages and out["stages"] == stages
    assert said.count(f"multiscale stage {stages}/{stages}") == 2
    assert max(first) > 0
    updates = stages if "--src-update" in flags else 0
    assert out["src_updates"] == updates
    assert said.count("source wavelets re-estimated") == 2 * updates
    it = np.loadtxt(os.path.join(ep, "Results", "loss.txt"), ndmin=2)[:, 0]
    assert (np.diff(it) == 1).all()  # one running count over the stages
