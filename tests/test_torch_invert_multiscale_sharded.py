"""`invert --multiscale --n-devices 3` of the port on the CPU, at the size of
tests/test_cli.py's TINY (3 shots): the six band-pass stages run on a mesh of
3 CPU shards (tests/test_cli.py::test_invert_multiscale_sharded, where the
JAX CLI shards by default).  A file of its own: its 6 stages over 3 shard
threads take about 20 s.
"""
import os

import numpy as np
from torch_threads import one_thread  # noqa: F401  (autouse)

from sep2023_tpu_torch import cli


def test_invert_multiscale_n_devices(tmp_path, capsys):
    """--multiscale over 3 shards: every stage's loss (one static band-pass
    a stage) runs on the mesh."""
    exp = str(tmp_path / "mesh")
    out = cli.main(["invert", "--nz", "28", "--nx", "48", "--nt", "80",
                    "--npml", "8", "--niter", "6", "--x64",
                    "--device", "cpu", "--multiscale", "--n-devices", "3",
                    "--exp-name", exp])
    assert "multi-chip: 3-device shot mesh" in capsys.readouterr().out
    h = np.loadtxt(os.path.join(exp, "Results", "loss.txt"), ndmin=2)
    assert out["stages"] == 6 and len(h) >= 1 and np.isfinite(h).all()
