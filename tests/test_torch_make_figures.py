"""examples/make_figures_torch.py in --exp mode on the CPU: on a tiny
`invert` result it writes the shot gather, the snapshot movie (through
cuda_engine.snapshots_cuda_plan's plain version), the rtm image and its
figure, and the models figure of the experiment.  The figures' problems are
cut to 32x64 for the CPU through the module's NZ, NX, NT and RTM_NT."""
import os
import sys
from pathlib import Path

from sep2023_tpu_torch import cli

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import make_figures_torch  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)


def test_make_figures_exp_mode(tmp_path, monkeypatch):
    for name, size in (("NZ", 32), ("NX", 64), ("NT", 200), ("RTM_NT", 300)):
        monkeypatch.setattr(make_figures_torch, name, size)
    exp = str(tmp_path / "exp")
    cli.main(["invert", "--nz", "28", "--nx", "48", "--nt", "80", "--npml",
              "8", "--niter", "1", "--x64", "--device", "cpu",
              "--exp-name", exp])
    out = tmp_path / "figs"
    made = make_figures_torch.main(
        [str(out), "--exp", exp, "--device", "cpu"])
    names = ["shot_gather.png", "wavefield.png", "rtm.png",
             "fwi_models.png"]
    assert [os.path.basename(p) for p in made["figures"]] == names
    for name in [*names, "rtm_image.npz"]:
        assert (out / name).stat().st_size > 0, name


def test_raster_figures_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed (the machine with the card) each
    figure is an RGB PNG of its panels side by side, 4 px apart."""
    import zlib

    import numpy as np
    from matplotlib import pyplot

    monkeypatch.setattr(make_figures_torch, "plt", None)
    rng = np.random.default_rng(0)
    snaps = make_figures_torch.plot_snaps(rng.standard_normal((7, 30, 40)),
                                          str(tmp_path))
    gather = make_figures_torch.plot_gather(
        rng.standard_normal((4, 12, 50)), 0.002, str(tmp_path))
    for path, (h, w) in ((snaps, (30, 6 * 44)), (gather, (50, 4 * 16))):
        raw = open(path, "rb").read()
        assert raw[:8] == b"\x89PNG\r\n\x1a\n"
        img = pyplot.imread(path)          # a valid PNG, decoded
        assert img.shape == (h, w, 3)
        assert img[:, -4:].min() == 1.0    # white between the panels
        assert zlib.crc32(raw[12:29]) == int.from_bytes(raw[29:33], "big")
