"""examples/overthrust_das_torch.py on the CPU, mirroring
tests/test_examples.py's overthrust smoke: at n_iters=3, nt=260,
src_step=25 it completes, the misfit and the illuminated-zone vp error
improve, and the npz artifact is written.  Its misfit0 is held to the JAX
package's in tests/test_torch_example_misfits.py.  Two torch threads (about
4.8 s an evaluation here, 6.1-6.5 s with one, on an 8-core host)."""
import sys
from pathlib import Path

from torch_threads import two_threads  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))


def test_overthrust_das_smoke(tmp_path):
    from overthrust_das_torch import main

    m = main(outdir=str(tmp_path), n_iters=3, nt=260, src_step=25,
             device="cpu")
    assert m["misfit1"] < 0.9 * m["misfit0"], m
    assert m["zone_err1"] < m["zone_err0"], m
    assert (tmp_path / "overthrust_das.npz").exists()
