"""`invert --n-devices` of the port against the JAX CLI, on the CPU.

At the size of tests/test_cli.py's TINY (3 shots, 28 receivers, 80 steps,
float64): the port's `invert --device cpu --n-devices k` (k CPU shards,
`parallel.shot_mesh`) gives the loss.txt trajectory of `--n-devices 1` and
of the JAX CLI's default, which shards the 3 shots over 3 of conftest's
virtual devices (tests/test_cli.py::
test_invert_sharded_trajectory_matches_single), with 3 shards and with 2,
which pad the shots to 4.  The multiscale stage loop on the mesh is in
tests/test_torch_invert_multiscale_sharded.py.
"""
import os

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401  (autouse)

from sep2023_tpu import cli as jcli
from sep2023_tpu_torch import cli

TINY = ["--nz", "28", "--nx", "48", "--nt", "80", "--npml", "8",
        "--niter", "2", "--x64"]


def _hist(exp):
    return np.loadtxt(os.path.join(exp, "Results", "loss.txt"), ndmin=2)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """loss.txt of the port's `--n-devices 1` and of the JAX CLI's default
    (a 3-device shot mesh)."""
    d = tmp_path_factory.mktemp("refs")
    one, jax_mesh = str(d / "one"), str(d / "jax")
    cli.main(["invert", *TINY, "--device", "cpu", "--n-devices", "1",
              "--exp-name", one])
    jcli.main(["invert", *TINY, "--exp-name", jax_mesh])
    return _hist(one), _hist(jax_mesh)


@pytest.mark.parametrize("n_devices,shots", [(3, 3), (2, 4)],
                         ids=["3 shards", "2 shards, padded"])
def test_invert_n_devices_matches_one_device_and_jax(
        tmp_path, capsys, references, n_devices, shots):
    one, jax_mesh = references
    exp = str(tmp_path / "mesh")
    scratch = str(tmp_path / "scratch")
    out = cli.main(["invert", *TINY, "--device", "cpu", "--n-devices",
                    str(n_devices), "--exp-name", exp, "--scratch-dir",
                    scratch])
    printed = capsys.readouterr().out
    assert (f"multi-chip: {n_devices}-device shot mesh ({shots} shots incl. "
            "padding)") in printed
    h = _hist(exp)
    assert h.shape == one.shape == jax_mesh.shape == (2, 2)
    np.testing.assert_allclose(h, one, rtol=1e-6)
    np.testing.assert_allclose(h, jax_mesh, rtol=1e-6)
    assert h[-1, 1] < h[0, 1] and out["nit"] == 2
    # the dumps hold the 3 real shots, not the padding
    assert sorted(f for f in os.listdir(os.path.join(scratch, "Syn"))
                  if f.startswith("Shot_ett")) == [
        f"Shot_ett{i}.bin" for i in range(3)]

