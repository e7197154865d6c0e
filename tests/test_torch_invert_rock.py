"""`invert` of the reference's rock-physics scripts on the port, against the
JAX package's, on the CPU in float64 (tests/torch_invert_parity.py):
Main-004 (--head rock_gassmann), its VRH variant (--head rock_vrh) and
Main-005 (--model rock with the velocity head)."""
import os

import numpy as np
import pytest

from torch_invert_parity import run_both


@pytest.mark.parametrize("flags,names", [
    (["--head", "rock_gassmann"], ["cc", "phi", "sw"]),
    (["--head", "rock_vrh"], ["cc", "phi", "sw"]),
    (["--model", "rock"], ["rho", "vp", "vs"]),
], ids=["rock_gassmann", "rock_vrh", "model_rock"])
def test_rock_invert_matches_jax(tmp_path, monkeypatch, flags, names):
    out, ep, _, first = run_both(tmp_path, monkeypatch, flags)
    assert first[0] > 0 and out["misfit"] < first[0]
    with np.load(os.path.join(ep, "Results", "model_0000.npz")) as z:
        assert sorted(z.files) == names
        assert z[names[0]].shape == (28, 48)
        if names[0] == "cc":
            # L-BFGS-B keeps the PCS parameters inside their bounds
            assert 0.05 <= z["phi"].min() and z["phi"].max() <= 0.4
            assert 0.2 <= z["sw"].min() and z["sw"].max() <= 1.0
