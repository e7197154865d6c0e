"""The port stands alone and never falls back.

* Importing sep2023_tpu_torch (cli, api, the CUDA engines, the invert
  path's modules, acoustic, imaging) loads neither jax nor sep2023_tpu: the
  machine with the card has no JAX.  No module of the port names either in
  an import statement.
* forward_cuda_plan, backward_cuda_plan, reconstruct_cuda_plan,
  propagate_cuda_plan, make_cuda_misfit, ElasticPropagator.apply_gradient
  and `cli invert` on a device that is not the CPU build and launch the
  kernels or raise; they never run the plain versions instead.
* The wrappers reject what the kernels do not take before any pointer is
  passed, and the kernels have no atomics (the gradient is the same from
  run to run).
* No grid size and no plannable survey raises on the card: multi-row
  spreads and the 560x720 and 814x2064 grids reach the kernel wrapper.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sep2023_tpu_torch import api, cli, parallel
from sep2023_tpu_torch.config import SimConfig, Survey
from sep2023_tpu_torch.ops import _build, cuda_acoustic, cuda_engine

REPO = Path(__file__).resolve().parents[1]

CFG = SimConfig(nz=24, nx=30, dz=20.0, dx=20.0, nt=12, dt=0.002, f0=10.0,
                npml=4)
RS = cuda_engine.RowSurvey(rec_row=15, rec_x0=5, n_rec=10)
PLAN = cuda_engine.plan_for(CFG, RS)


def _inputs(device="cpu", dtype=torch.float32, S=2):
    plane = lambda v: torch.full((CFG.nz, CFG.nx), v, device=device,
                                 dtype=dtype)
    stf = torch.ones((S, CFG.nt), device=device, dtype=dtype)
    return (plane(6e9), plane(6e9), plane(2500.0), stf,
            np.full(S, 2), np.full(S, 10), np.ones(S))


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'examples')\n"
        "import das_fwi_torch\n"
        "import sep2023_tpu_torch.analytic, sep2023_tpu_torch.das\n"
        "import sep2023_tpu_torch, sep2023_tpu_torch.cli, "
        "sep2023_tpu_torch.api, sep2023_tpu_torch.ops.cuda_engine, "
        "sep2023_tpu_torch.convert, sep2023_tpu_torch.io, "
        "sep2023_tpu_torch.heads, sep2023_tpu_torch.optimize, "
        "sep2023_tpu_torch.ops.misfit, sep2023_tpu_torch.parallel, "
        "sep2023_tpu_torch.testing, sep2023_tpu_torch.acoustic, "
        "sep2023_tpu_torch.imaging, sep2023_tpu_torch.ops.cuda_acoustic\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sep2023_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_module_imports_jax():
    """Every module of the port, chip_smoke.py and the port's examples:
    no import statement names jax or the JAX package."""
    files = [*sorted((REPO / "sep2023_tpu_torch").rglob("*.py")),
             REPO / "chip_smoke.py",
             *sorted((REPO / "examples").glob("*_torch.py"))]
    assert len(files) > 20
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sep2023_tpu)(\.|\s|$)",
                     re.MULTILINE)
    for f in files:
        assert not pat.search(f.read_text()), f.name


def test_acoustic_entries_raise_when_build_fails(monkeypatch):
    """The acoustic wrappers on a device that is not the CPU reach the
    kernel build and no plain version."""
    _broken_build(monkeypatch)
    lam, _, rho, stf, sz, sx, _ = _inputs(device="meta")
    meta = lambda *shape: torch.zeros(shape, device="meta")
    S, n = 2, cuda_engine.propagator.strip_len(CFG)
    final, strips = meta(3, S, CFG.nz, CFG.nx), meta(S, CFG.nt - 1, 3, n)
    d = meta(S, 3, RS.n_rec, CFG.nt)
    before = (cuda_acoustic.LAUNCHES_AC, cuda_acoustic.LAUNCHES_AC_BWD)
    calls = (
        lambda: cuda_acoustic.forward_cuda_acoustic_plan(
            PLAN, lam, rho, stf, sz, sx, save_strips=True),
        lambda: cuda_acoustic.backward_cuda_acoustic_plan(
            PLAN, lam, rho, stf, sz, sx, final, strips, d),
        lambda: cuda_acoustic.reconstruct_cuda_acoustic_plan(
            PLAN, lam, rho, stf, sz, sx, final, strips),
        lambda: cuda_acoustic.rtm_image_time_cuda_plan(
            PLAN, lam, rho, stf, sz, sx, d),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="simulated"):
            call()
    assert (cuda_acoustic.LAUNCHES_AC, cuda_acoustic.LAUNCHES_AC_BWD) == \
        before


def test_forward_cuda_raises_when_build_fails(monkeypatch):
    def broken_build():
        raise RuntimeError("nvcc failed (simulated)")

    def no_plain(*a, **k):
        raise AssertionError("the forward fell back to the plain version")

    monkeypatch.setattr(_build, "_LIB", None)  # as in a fresh process
    monkeypatch.setattr(_build, "build", broken_build)
    monkeypatch.setattr(cuda_engine, "forward_plain", no_plain)
    before = cuda_engine.LAUNCHES
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_engine.forward_cuda_plan(PLAN, *_inputs(device="meta"))
    assert cuda_engine.LAUNCHES == before


def test_library_path_keyed_by_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text("// one\n")
    p1 = _build.library_path()
    assert p1 == _build.library_path()
    (tmp_path / "a.cu").write_text("// two\n")
    p2 = _build.library_path()
    assert p1 != p2 and p2.parent == _build.BUILD_DIR
    real = [p.name for p in sorted((REPO / "sep2023_tpu_torch" / "csrc")
                                   .glob("*.cu"))]
    assert "elastic_fwd.cu" in real


@pytest.mark.parametrize("case,exc,match", [
    ("f64", TypeError, "float32"),
    ("weighted", ValueError, "FiberSurvey with weights"),
    ("fiber", TypeError, "RowSurvey or a FiberSurvey"),
    ("fiber_no_weights", ValueError, "weights"),
    ("fiber_corner", ValueError, "recordable range"),
    ("src_out", ValueError, "src_z outside"),
    ("rec_edge", ValueError, "does not fit"),
    ("stf_shape", ValueError, "stf must be"),
    ("noncontig", ValueError, "contiguous"),
])
def test_forward_cuda_rejects(case, exc, match):
    cfg, rs = CFG, RS
    lam, mu, rho, stf, sz, sx, rxz = _inputs(
        dtype=torch.float64 if case == "f64" else torch.float32)
    if case == "weighted":
        cfg = SimConfig(**{**CFG.__dict__, "das_channel": "weighted"})
    elif case == "fiber":
        rs = None
    elif case == "fiber_no_weights":
        cfg = SimConfig(**{**CFG.__dict__, "das_channel": "weighted"})
        rs = cuda_engine.make_fiber_survey([15, 16], [5, 6])
    elif case == "fiber_corner":
        rs = cuda_engine.make_fiber_survey([0, 15], [0, 6])
    elif case == "src_out":
        sz = np.array([2, CFG.nz])
    elif case == "rec_edge":
        rs = cuda_engine.RowSurvey(rec_row=15, rec_x0=0, n_rec=10)  # x-1 < 0
    elif case == "stf_shape":
        stf = stf[:, :-1].contiguous()
    elif case == "noncontig":
        lam = torch.full((CFG.nx, CFG.nz), 6e9).t()
    with pytest.raises(exc, match=match):
        cuda_engine.forward_cuda_plan(cuda_engine.plan_for(cfg, rs), lam, mu,
                                      rho, stf, sz, sx, rxz)


def test_check_row_survey():
    assert cuda_engine.check_row_survey(np.full(5, 7), np.arange(3, 8)) == \
        cuda_engine.RowSurvey(7, 3, 5)
    assert cuda_engine.check_row_survey(np.array([7, 8]),
                                        np.array([3, 4])) is None
    assert cuda_engine.check_row_survey(np.array([7, 7]),
                                        np.array([3, 5])) is None


def _broken_build(monkeypatch):
    """A fresh process whose nvcc fails, and plain versions that must not
    be reached."""
    def broken_build():
        raise RuntimeError("nvcc failed (simulated)")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA entry point ran a plain version")

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", broken_build)
    for name in ("forward_plain", "forward_plain_strips", "backward_plain",
                 "reconstruct_plain"):
        monkeypatch.setattr(cuda_engine, name, no_plain)
    for name in ("forward_plain_acoustic", "forward_plain_acoustic_strips",
                 "backward_plain_acoustic", "reconstruct_plain_acoustic",
                 "rtm_image_time_plain"):
        monkeypatch.setattr(cuda_acoustic, name, no_plain)
    monkeypatch.setattr(cuda_engine.propagator, "propagate_shots", no_plain)


def test_backward_entries_raise_when_build_fails(monkeypatch):
    _broken_build(monkeypatch)
    lam, mu, rho, stf, sz, sx, rxz = _inputs(device="meta")
    S, n = 2, cuda_engine.propagator.strip_len(CFG)
    meta = lambda *shape: torch.zeros(shape, device="meta")
    final = meta(5, S, CFG.nz, CFG.nx)
    strips = meta(S, CFG.nt - 1, 5, n)
    d = meta(S, 4, RS.n_rec, CFG.nt)
    before = (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_BWD)
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_engine.forward_cuda_plan(PLAN, lam, mu, rho, stf, sz, sx, rxz,
                                      save_strips=True)
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_engine.backward_cuda_plan(PLAN, lam, mu, rho, stf, sz, sx, rxz,
                                       final, strips, d)
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_engine.reconstruct_cuda_plan(PLAN, lam, mu, rho, stf, sz, sx,
                                          rxz, final, strips)
    assert (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_BWD) == before


def test_backward_cuda_rejects_bad_residuals():
    lam, mu, rho, stf, sz, sx, rxz = _inputs()
    final = torch.zeros(5, 2, CFG.nz, CFG.nx)
    strips = torch.zeros(2, CFG.nt - 1, 5,
                         cuda_engine.propagator.strip_len(CFG))
    d = torch.zeros(2, 4, RS.n_rec, CFG.nt)
    with pytest.raises(ValueError, match="strips must be"):
        cuda_engine.backward_cuda_plan(PLAN, lam, mu, rho, stf, sz, sx, rxz,
                                       final, strips[:, :-1].contiguous(), d)
    with pytest.raises(ValueError, match="d_data must be"):
        cuda_engine.backward_cuda_plan(PLAN, lam, mu, rho, stf, sz, sx, rxz,
                                       final, strips, d[..., :-1].contiguous())
    with pytest.raises(TypeError, match="float32"):
        cuda_engine.backward_cuda_plan(PLAN, lam, mu, rho, stf, sz, sx, rxz,
                                       final.double(), strips, d)


# A row survey on CFG's grid (padded rec_z 15) and a two-row one.
SURVEYS = {
    "row": dict(src_z=np.array([2, 2]), src_x=np.array([6, 14]),
                rec_z=np.full(10, 11), rec_x=np.arange(1, 11)),
    "two_rows": dict(src_z=np.array([2, 2]), src_x=np.array([6, 14]),
                     rec_z=np.repeat([11, 12], 5), rec_x=np.arange(1, 11)),
}


@pytest.mark.parametrize("entry", ["propagate_cuda", "make_cuda_misfit",
                                   "apply_gradient"])
@pytest.mark.parametrize("case,exc,match", [
    ("two_rows", RuntimeError, "simulated"),
    ("f64", NotImplementedError, "float32"),
    ("build", RuntimeError, "simulated"),
])
def test_gradient_entries_off_cpu_raise(monkeypatch, entry, case, exc,
                                        match):
    """On a device that is not the CPU, the invert path's entry points run
    the kernels or raise: never the plain propagator.  A two-row spread
    plans as point receivers and reaches the kernel build like a row."""
    _broken_build(monkeypatch)
    sv = Survey(**SURVEYS["two_rows" if case == "two_rows" else "row"])
    dtype = torch.float64 if case == "f64" else torch.float32
    lam, mu, rho, stf, _, _, _ = _inputs(device="meta", dtype=dtype)
    params = [a.requires_grad_() for a in (lam, mu, rho, stf)]
    cfg = CFG
    with pytest.raises(exc, match=match):
        if entry == "propagate_cuda":
            rs = cuda_engine.plan_fast_path(cfg, sv.rec_z + cfg.npml,
                                            sv.rec_x + cfg.npml).rs
            assert isinstance(rs, cuda_engine.FiberSurvey) == \
                (case == "two_rows")
            out = cuda_engine.propagate_cuda_plan(
                cuda_engine.plan_for(cfg, rs), *params,
                sv.src_z + cfg.npml, sv.src_x + cfg.npml, sv.src_rxz)
            out.sum().backward()
        elif entry == "make_cuda_misfit":
            loss = parallel.make_cuda_misfit(cfg, sv)
            obs = torch.zeros((2, 4, sv.n_rec, cfg.nt), device="meta",
                              dtype=dtype)
            loss(*params, obs, torch.ones(2, device="meta", dtype=dtype))
        else:
            model = api.Model(nx=cfg.nx - 8, nz=cfg.nz - 8, dx=20.0,
                              dz=20.0, nt=cfg.nt, dt=cfg.dt, nPml=4,
                              vp=np.full((16, 22), 3000.0),
                              vs=np.full((16, 22), 1700.0),
                              rho=np.full((16, 22), 2500.0))
            prop = api.ElasticPropagator(model, sv, device="meta",
                                         dtype=dtype)
            prop.apply_gradient(model, np.zeros((2, 4, sv.n_rec, cfg.nt)))


def test_apply_gradient_one_device_only():
    model = api.Model(nx=22, nz=16, dx=20.0, dz=20.0, nt=12, dt=0.002,
                      nPml=4, vp=np.full((16, 22), 3000.0),
                      vs=np.full((16, 22), 1700.0),
                      rho=np.full((16, 22), 2500.0))
    prop = api.ElasticPropagator(model, Survey(**SURVEYS["row"]),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="M10"):
        prop.apply_gradient(model, np.zeros((2, 4, 10, 12)), n_devices=2)


def test_cli_invert_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """`invert --device cuda` (the default) without a card raises; it does
    not fall back to the CPU."""
    _broken_build(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cli.main(["invert", "--nz", "16", "--nx", "24", "--nt", "12",
                  "--npml", "4", "--exp-name", str(tmp_path)])


def test_backward_kernel_has_no_atomics():
    """Every transpose is a gather, the point receivers' too: no atomic
    operation in the code of any kernel source (comments aside)."""
    names = sorted(p.name for p in (REPO / "sep2023_tpu_torch" / "csrc")
                   .iterdir())
    assert names == ["acoustic_bwd.cu", "acoustic_common.cuh",
                     "acoustic_fwd.cu", "elastic_bwd.cu",
                     "elastic_common.cuh", "elastic_fwd.cu"]
    for name in names:
        src = (REPO / "sep2023_tpu_torch" / "csrc" / name).read_text()
        code = re.sub(r"//[^\n]*", "", src)
        assert "__global__" in code or name.endswith(".cuh")
        assert not re.search(r"atomic", code, re.IGNORECASE), name


@pytest.mark.parametrize("nz,nx", [(560, 720), (814, 2064)])
def test_streamed_scale_gradient_raises_on_the_card(monkeypatch, nz, nx):
    """Past the JAX package's fused range (560x720 and 814x2064 padded, its
    streamed pair's grids) no size gate is left: a gradient on a device
    that is not the CPU reaches the kernel build, and raises only because
    the build here fails; it never runs a plain version."""
    _broken_build(monkeypatch)
    cfg = SimConfig(nz=nz, nx=nx, dz=10.0, dx=10.0, nt=12, dt=0.001,
                    f0=10.0, npml=32)
    rs = cuda_engine.RowSurvey(rec_row=nz - 44, rec_x0=42, n_rec=nx - 84)
    meta = lambda *shape: torch.zeros(shape, device="meta")
    lam, mu, rho = (meta(nz, nx).requires_grad_() for _ in range(3))
    stf = meta(2, 12).requires_grad_()
    idx = (np.full(2, 33), np.array([100, 600]), np.ones(2))
    assert not hasattr(cuda_engine, "in_fused_range")
    assert not hasattr(cuda_engine, "check_fused_range")
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_engine.propagate_cuda_plan(cuda_engine.plan_for(cfg, rs), lam,
                                        mu, rho, stf, *idx)
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_engine.backward_cuda_plan(
            cuda_engine.plan_for(cfg, rs), lam.detach(), mu.detach(),
            rho.detach(), stf.detach(), *idx, meta(5, 2, nz, nx),
            meta(2, 11, 5, cuda_engine.propagator.strip_len(cfg)),
            meta(2, 4, nx - 84, 12))
