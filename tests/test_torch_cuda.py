"""The CUDA kernels against their plain PyTorch versions on the card, float32:
the forward (2e-5 of each channel's max), the forward with boundary strips
(data, strips and final fields to 2e-5), the boundary-saving adjoint
(5e-4 of each gradient's max, the same bits on a second run), the adjoint
dot product (5e-5) and the reconstruction (at most 10x the plain
residual), on receiver rows (ROW_CASES) and on point receivers
(FIBER_CASES: a weighted arc fiber, a column, duplicate points); and the
acoustic kernels on AC_CASES (a row, duplicate points, a column) to the same
tolerances, with the image and illumination of the imaging variant (5e-4).
The fused elastic kernels also on TILE_EDGE_CASES and the fused acoustic
kernels on AC_TILE_EDGE_CASES, where the edges of their tiles can bite:
data, strips and final fields bitwise equal to plain, gradients, a second
backward bitwise, the reconstruction residual equal to plain's, the image
and illumination.  The elastic illumination kernel (the fused step with its
accumulator) bitwise equal to imaging.source_illumination, and the
snapshot route (the forward copying its state every save_every steps)
bitwise equal to its plain version.  A point table
built for other tiles than the kernel's raises, in the elastic forward and
backward and in the acoustic forward and backward.  The acoustic backward
and its imaging variant with point receivers (the cotangents added inside
the fused reverse step): against plain, a second run bitwise, nt launches.
The elastic and the acoustic shot sums (one body, csrc/shot_sum.cuh)
bitwise equal to a plain loop over shots, with a per-shot stride that is a
multiple of 4 floats and one that is not, and planes off 16-byte alignment.
The kernels' sharded loss over a mesh that repeats the card against the
unsharded loss (loss 1e-6, gradients 2e-5 of each max, exact launches, a
second evaluation bitwise).  The plain engine on the card in float64
(`invert --x64`, ElasticPropagator(dtype=torch.float64)) against the same
run on the CPU, to 1e-9 relative, with no kernel launch, and in float32 on
a survey no plan takes, which --engine auto and pallas refuse on the card
(`invert --engine xla`, over a mesh of the card too, and
ElasticPropagator(engine='xla')) to 1e-6.
These mirror phases 3, 7-10, 12, 17, 19e, 20-23, 26, 29 and 30 of
chip_smoke.py;
they need a CUDA device and nvcc, and skip without a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
    python -m pytest --noconftest tests/test_torch_cuda.py -k sum_shots
"""
import numpy as np
import pytest
import torch

from sep2023_tpu_torch import (api, cli, imaging, medium, models, parallel,
                               propagator)
from sep2023_tpu_torch.ops import _build, cuda_acoustic, cuda_engine
from sep2023_tpu_torch.testing import (AC_CASES, AC_INTERIOR,
                                       AC_TILE_EDGE_CASES, CORNER_INVERT,
                                       DOT_TOL,
                                       FIBER_CASES, FWD_TOL, GRAD_TOL,
                                       PLAIN_DEVICE_TOL,
                                       PLAIN_F32_DEVICE_TOL, RECON_RATIO,
                                       ROW_CASES, TILE_EDGE_CASES,
                                       TILE_EDGE_SEED, TINY_INVERT,
                                       ac_perturbed_cotangent, ac_problem,
                                       ac_tile_edge_problem, acoustic_args,
                                       adjoint_gap, api_problem,
                                       corner_api_problem, corner_survey,
                                       fiber_problem, grad_errors,
                                       invert_run, max_rel,
                                       perturbed_cotangent,
                                       reconstruction_residual, rel_diff,
                                       repeated_shot_mesh, row_problem,
                                       strip_errors, tile_edge_problem)

pytestmark = pytest.mark.cuda

AC_POINT_CASES = [f"points: {k}" for k in AC_CASES if k != "row"] + [
    f"tile edges: {k}" for k, v in AC_TILE_EDGE_CASES.items()
    if v[-1][0] == "points"]


def _ac_point_problem(case, device):
    kind, name = case.split(": ", 1)
    if kind == "points":
        return ac_problem(name, device=device)
    return ac_tile_edge_problem(name, device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _compare(cfg, rs, args, tol):
    before = cuda_engine.LAUNCHES
    out = cuda_engine.forward_cuda_plan(cuda_engine.plan_for(cfg, rs), *args)
    torch.cuda.synchronize()
    assert cuda_engine.LAUNCHES - before == cuda_engine.launches_forward(cfg)
    ref = cuda_engine.forward_plain(cfg, rs, *args)
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(out).all()
    assert np.abs(ref[:, 3]).max() > 1e-3
    for c in range(4):
        rel = np.abs(out[:, c] - ref[:, c]).max() / np.abs(ref[:, c]).max()
        assert rel < tol, (c, rel)


@pytest.mark.parametrize("das_channel", ["exx", "ezz"])
def test_kernel_matches_plain_small(cuda, das_channel):
    cfg, rs, args = row_problem(*ROW_CASES[f"small {das_channel}"],
                                device=cuda)
    _compare(cfg, rs, args, 2e-5)


def test_kernel_matches_plain_reference_shape(cuda):
    cfg, rs, args = row_problem(*ROW_CASES["reference shape nt=301"],
                                device=cuda)
    assert (cfg.nz, cfg.nx, rs.n_rec) == (165, 265, 181)
    _compare(cfg, rs, args, 2e-5)


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_strips_kernel_matches_plain(cuda, case):
    cfg, rs, args = row_problem(*ROW_CASES[case], device=cuda)
    before = (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_STRIPS)
    out = cuda_engine.forward_cuda_plan(cuda_engine.plan_for(cfg, rs), *args,
                                        save_strips=True)
    torch.cuda.synchronize()
    steps = cuda_engine.launches_forward(cfg)
    assert (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_STRIPS) == \
        (before[0] + steps, before[1] + steps)
    d, s, f = strip_errors(out, cuda_engine.forward_plain_strips(cfg, rs,
                                                                 *args))
    assert max(d + s + f) < FWD_TOL, (d, s, f)


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_backward_kernel_matches_plain(cuda, case):
    cfg, rs, args = row_problem(*ROW_CASES[case], device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    syn, strips, final = cuda_engine.forward_cuda_plan(plan, *args,
                                                       save_strips=True)
    assert float(syn[:, 3].abs().max()) > 1e-3
    res = (*args, final, strips, perturbed_cotangent(cfg, rs, args, syn))
    before = cuda_engine.LAUNCHES_BWD
    out = cuda_engine.backward_cuda_plan(plan, *res)
    again = cuda_engine.backward_cuda_plan(plan, *res)
    torch.cuda.synchronize()
    assert cuda_engine.LAUNCHES_BWD - before == \
        2 * cuda_engine.launches_backward(cfg, rs)
    for a, b in zip(out, again):  # no atomics: the same bits every run
        assert torch.equal(a, b)
    err = grad_errors(out, cuda_engine.backward_plain(cfg, rs, *res), cfg)
    assert max(err) < GRAD_TOL, err


@pytest.mark.parametrize("case", ["small exx", "small ezz"])
def test_adjoint_dot_product(cuda, case):
    cfg, rs, args = row_problem(*ROW_CASES[case], device=cuda)
    _, _, gap = adjoint_gap(cfg, rs, args)
    assert gap <= DOT_TOL


def test_reconstruction_residual(cuda):
    cfg, rs, args = row_problem(*ROW_CASES["reference shape nt=301"],
                                device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    data, strips, final = cuda_engine.forward_cuda_plan(plan, *args,
                                                        save_strips=True)
    kern = reconstruction_residual(cfg, cuda_engine.reconstruct_cuda_plan(
        plan, *args, final, strips), data)
    plain = reconstruction_residual(cfg, cuda_engine.reconstruct_plain(
        cfg, rs, *args, final, strips), data)
    assert np.isfinite(kern) and kern <= RECON_RATIO * plain, (kern, plain)


@pytest.mark.parametrize("case", list(FIBER_CASES))
def test_fiber_forward_matches_plain(cuda, case):
    """Point recording inside the fused step: data, strips and final
    fields, nt launches, one of them the record-only launch."""
    cfg, rs, args = fiber_problem(case, device=cuda)
    before = (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_FIBER)
    out = cuda_engine.forward_cuda_plan(cuda_engine.plan_for(cfg, rs), *args,
                                        save_strips=True)
    torch.cuda.synchronize()
    assert cuda_engine.launches_forward(cfg) == cfg.nt
    assert (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_FIBER) == \
        (before[0] + cfg.nt, before[1] + 1)
    ref = cuda_engine.forward_plain_strips(cfg, rs, *args)
    assert float(ref[0][:, 3].abs().max()) > 1e-3
    d, s, f = strip_errors(out, ref)
    assert max(d + s + f) < FWD_TOL, (d, s, f)


@pytest.mark.parametrize("case", list(FIBER_CASES))
def test_fiber_backward_matches_plain(cuda, case):
    """The point receivers' cotangents added inside the fused reverse step:
    gradients, the same bits on a second run, nt launches a backward, and
    the adjoint identity."""
    cfg, rs, args = fiber_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    syn, strips, final = cuda_engine.forward_cuda_plan(plan, *args,
                                                       save_strips=True)
    res = (*args, final, strips, perturbed_cotangent(cfg, rs, args, syn))
    before = cuda_engine.LAUNCHES_BWD
    out = cuda_engine.backward_cuda_plan(plan, *res)
    again = cuda_engine.backward_cuda_plan(plan, *res)
    torch.cuda.synchronize()
    assert cuda_engine.launches_backward(cfg, rs) == cfg.nt
    assert cuda_engine.LAUNCHES_BWD - before == 2 * cfg.nt
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    err = grad_errors(out, cuda_engine.backward_plain(cfg, rs, *res), cfg)
    assert max(err) < GRAD_TOL, err
    _, _, gap = adjoint_gap(cfg, rs, args)
    assert gap <= DOT_TOL


@pytest.mark.parametrize("case", list(AC_CASES))
def test_acoustic_forward_matches_plain(cuda, case):
    """acoustic_forward with and without strips: data, strips and final
    fields (2e-5), nt launches a forward (recording inside the fused step,
    the last launch recording only), the same data either way."""
    cfg, rs, args = ac_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    before = (cuda_acoustic.LAUNCHES_AC, cuda_acoustic.LAUNCHES_AC_STRIPS)
    out = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args,
                                                   save_strips=True)
    data = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args)
    torch.cuda.synchronize()
    steps = cfg.nt
    assert steps == cuda_acoustic.launches_forward_acoustic(cfg)
    assert (cuda_acoustic.LAUNCHES_AC, cuda_acoustic.LAUNCHES_AC_STRIPS) == \
        (before[0] + 2 * steps, before[1] + steps)
    assert torch.equal(data, out[0])
    ref = cuda_acoustic.forward_plain_acoustic_strips(cfg, rs, *args)
    assert all(float(ref[0][:, c].abs().max()) > 1e-3 for c in range(3))
    d, s, f = strip_errors(out, ref)
    assert max(d + s + f) < FWD_TOL, (d, s, f)


@pytest.mark.parametrize("case", list(AC_CASES))
def test_acoustic_backward_matches_plain(cuda, case):
    """acoustic_backward: gradients on the tight interior shrunk by 2
    (5e-4), the same bits on a second run, the launch count, the adjoint
    identity (5e-5) and the reconstruction residual."""
    cfg, rs, args = ac_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    syn, strips, final = cuda_acoustic.forward_cuda_acoustic_plan(
        plan, *args, save_strips=True)
    res = (*args, final, strips, ac_perturbed_cotangent(cfg, rs, args, syn))
    before = cuda_acoustic.LAUNCHES_AC_BWD
    out = cuda_acoustic.backward_cuda_acoustic_plan(plan, *res)
    again = cuda_acoustic.backward_cuda_acoustic_plan(plan, *res)
    torch.cuda.synchronize()
    assert cuda_acoustic.LAUNCHES_AC_BWD - before == \
        2 * cuda_acoustic.launches_backward_acoustic(cfg, rs)
    for a, b in zip(out, again):  # no atomics: the same bits every run
        assert torch.equal(a, b)
    ref = cuda_acoustic.backward_plain_acoustic(cfg, rs, *res)
    assert all(float(a.abs().max()) > 0 for a in ref)
    err = grad_errors(out, ref, cfg, AC_INTERIOR)
    assert max(err) < GRAD_TOL, err
    _, _, gap = adjoint_gap(cfg, rs, args)
    assert gap <= DOT_TOL
    kern = reconstruction_residual(
        cfg, cuda_acoustic.reconstruct_cuda_acoustic_plan(
            plan, *args, final, strips), syn)
    plain = reconstruction_residual(
        cfg, cuda_acoustic.reconstruct_plain_acoustic(
            cfg, rs, *args, final, strips), syn)
    assert np.isfinite(kern) and kern <= RECON_RATIO * plain, (kern, plain)


@pytest.mark.parametrize("case", list(AC_CASES))
def test_acoustic_image_matches_plain(cuda, case):
    """The imaging variant of acoustic_backward: image and illumination of
    every shot against rtm_image_time_plain (5e-4 of each one's max), and
    their sums over shots."""
    cfg, rs, args = ac_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    lam, rho, stf, src_z, src_x = args
    vp = torch.sqrt(lam / rho).contiguous()
    syn = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args)
    residual = -ac_perturbed_cotangent(cfg, rs, args, syn)
    before = cuda_acoustic.LAUNCHES_AC_IMG
    img, ill = cuda_acoustic.rtm_image_time_cuda_plan(
        plan, vp, rho, stf, src_z, src_x, residual)
    assert cuda_acoustic.LAUNCHES_AC_IMG - before == \
        cuda_acoustic.launches_backward_acoustic(cfg, rs)
    img_p, ill_p = cuda_acoustic.rtm_image_time_plain(
        cfg, rs, vp, rho, stf, src_z, src_x, residual)
    assert float(img_p.abs().max()) > 0 and float(ill_p.max()) > 0
    assert max_rel(img, img_p) < GRAD_TOL and max_rel(ill, ill_p) < GRAD_TOL
    img_s, ill_s = cuda_acoustic.rtm_image_time_cuda_plan(
        plan, vp, rho, stf, src_z, src_x, residual, sum_shots=True)
    assert max_rel(img_s, img_p.sum(0)) < GRAD_TOL
    assert max_rel(ill_s, ill_p.sum(0)) < GRAD_TOL


@pytest.mark.parametrize("case", list(TILE_EDGE_CASES))
def test_tile_edges_forward_bitwise(cuda, case):
    """The fused forward where tile edges bite: data, strips and final
    fields bitwise equal to plain, the same data without strips, and the
    reconstruction residual equal to the plain f32 one."""
    cfg, rs, args = tile_edge_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    out = cuda_engine.forward_cuda_plan(plan, *args, save_strips=True)
    data = cuda_engine.forward_cuda_plan(plan, *args)
    ref = cuda_engine.forward_plain_strips(cfg, rs, *args)
    assert float(ref[0][:, 3].abs().max()) > 1e-3
    assert torch.equal(data, out[0])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    _, strips, final = out
    kern = reconstruction_residual(cfg, cuda_engine.reconstruct_cuda_plan(
        plan, *args, final, strips), data)
    plain = reconstruction_residual(cfg, cuda_engine.reconstruct_plain(
        cfg, rs, *args, final, strips), data)
    assert kern == plain, (kern, plain)


@pytest.mark.parametrize("case", ["row", "points"])
def test_snapshots_kernel_bitwise(cuda, case):
    """The snapshot route on the card (elastic_forward copying the state
    after every 25th step) against its plain version on the same card: the
    data and every snapshot bit for bit, launches_forward of the snapshot
    config, on a receiver row and on weighted point receivers."""
    if case == "row":
        cfg, rs, args = row_problem(*ROW_CASES["small exx"], device=cuda)
    else:
        cfg, rs, args = fiber_problem("arc weighted", device=cuda)
    before = cuda_engine.LAUNCHES
    data, snaps = cuda_engine.snapshots_cuda_plan(
        cuda_engine.plan_for(cfg, rs), *args, save_every=25)
    torch.cuda.synchronize()
    cfg_s = propagator.snapshot_config(cfg, 25)
    assert cuda_engine.LAUNCHES - before == \
        cuda_engine.launches_forward(cfg_s) == cfg_s.nt
    ref_data, ref_snaps = cuda_engine.snapshots_plain(cfg, rs, *args, 25)
    assert snaps.shape == ref_snaps.shape == ((cfg.nt - 1) // 25, 5,
                                              args[3].shape[0], cfg.nz,
                                              cfg.nx)
    assert float(ref_snaps.abs().max()) > 0
    assert torch.equal(data, ref_data)
    assert torch.equal(snaps, ref_snaps)


@pytest.mark.parametrize("case", ["fiber points on tile edges",
                                  "ragged tiles"])
def test_forward_refuses_a_table_of_other_tiles(cuda, case, monkeypatch):
    """A plan whose tables were built for tiles other than the kernel's
    (cuda_engine.TILE mistaken for 8 x 32) makes elastic_forward raise
    before any launch, for points and for a row."""
    cfg, rs, args = tile_edge_problem(case, device=cuda)
    monkeypatch.setattr(cuda_engine, "TILE", (8, 32))
    plan = cuda_engine.FastPlan(cfg, rs)   # not the cached plan
    before = cuda_engine.LAUNCHES
    with pytest.raises(RuntimeError, match="other tiles"):
        cuda_engine.forward_cuda_plan(plan, *args)
    assert cuda_engine.LAUNCHES == before


@pytest.mark.parametrize("case", ["points by a neighbour's halo",
                                  "ragged tiles"])
def test_backward_and_acoustic_forward_refuse_a_table_of_other_tiles(
        cuda, case, monkeypatch):
    """A plan whose tables were built for tiles other than the kernels'
    makes elastic_backward (its injection rows by tile) and
    acoustic_forward (its recording table) raise before any launch, for
    points and for a row."""
    cfg, rs, args = tile_edge_problem(case, device=cuda)
    syn, strips, final = cuda_engine.forward_cuda_plan(
        cuda_engine.plan_for(cfg, rs), *args, save_strips=True)
    monkeypatch.setattr(cuda_engine, "TILE", (8, 32))
    plan = cuda_engine.FastPlan(cfg, rs)   # not the cached plan
    before = (cuda_engine.LAUNCHES_BWD, cuda_acoustic.LAUNCHES_AC)
    with pytest.raises(RuntimeError, match="other tiles"):
        cuda_engine.backward_cuda_plan(plan, *args, final, strips, syn)
    with pytest.raises(RuntimeError, match="other tiles"):
        cuda_acoustic.forward_cuda_acoustic_plan(plan,
                                                 *acoustic_args(args))
    assert (cuda_engine.LAUNCHES_BWD, cuda_acoustic.LAUNCHES_AC) == before


@pytest.mark.parametrize("case", list(TILE_EDGE_CASES))
def test_tile_edges_backward(cuda, case):
    """The fused backward where tile edges bite: gradients within GRAD_TOL,
    a second backward bitwise, the launch count, the adjoint identity."""
    cfg, rs, args = tile_edge_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    syn, strips, final = cuda_engine.forward_cuda_plan(plan, *args,
                                                       save_strips=True)
    res = (*args, final, strips, perturbed_cotangent(cfg, rs, args, syn))
    before = cuda_engine.LAUNCHES_BWD
    out = cuda_engine.backward_cuda_plan(plan, *res)
    again = cuda_engine.backward_cuda_plan(plan, *res)
    torch.cuda.synchronize()
    assert cuda_engine.LAUNCHES_BWD - before == \
        2 * cuda_engine.launches_backward(cfg, rs)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    err = grad_errors(out, cuda_engine.backward_plain(cfg, rs, *res), cfg)
    assert max(err) < GRAD_TOL, err
    _, _, gap = adjoint_gap(cfg, rs, args, TILE_EDGE_SEED)
    assert gap <= DOT_TOL


@pytest.mark.parametrize("case", list(AC_TILE_EDGE_CASES))
def test_ac_tile_edges_forward_bitwise(cuda, case):
    """The fused acoustic forward where tile edges bite: data, strips and
    final fields bitwise equal to plain, the same data without strips, nt
    launches a forward, and the reconstruction residual equal to the plain
    f32 one."""
    cfg, rs, args = ac_tile_edge_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    before = cuda_acoustic.LAUNCHES_AC
    out = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args,
                                                   save_strips=True)
    data = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args)
    torch.cuda.synchronize()
    assert cuda_acoustic.LAUNCHES_AC - before == 2 * cfg.nt
    ref = cuda_acoustic.forward_plain_acoustic_strips(cfg, rs, *args)
    assert all(float(ref[0][:, c].abs().max()) > 1e-3 for c in range(3))
    assert torch.equal(data, out[0])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    _, strips, final = out
    kern = reconstruction_residual(
        cfg, cuda_acoustic.reconstruct_cuda_acoustic_plan(
            plan, *args, final, strips), data)
    plain = reconstruction_residual(
        cfg, cuda_acoustic.reconstruct_plain_acoustic(
            cfg, rs, *args, final, strips), data)
    assert kern == plain, (kern, plain)


@pytest.mark.parametrize("case", list(AC_TILE_EDGE_CASES))
def test_ac_tile_edges_backward(cuda, case):
    """The fused acoustic backward where tile edges bite: gradients on the
    tight interior less 2 within GRAD_TOL, a second backward bitwise, the
    launch count, the adjoint identity, and the imaging variant's image and
    illumination within GRAD_TOL."""
    cfg, rs, args = ac_tile_edge_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    syn, strips, final = cuda_acoustic.forward_cuda_acoustic_plan(
        plan, *args, save_strips=True)
    cot = ac_perturbed_cotangent(cfg, rs, args, syn)
    res = (*args, final, strips, cot)
    before = cuda_acoustic.LAUNCHES_AC_BWD
    out = cuda_acoustic.backward_cuda_acoustic_plan(plan, *res)
    again = cuda_acoustic.backward_cuda_acoustic_plan(plan, *res)
    torch.cuda.synchronize()
    assert cuda_acoustic.LAUNCHES_AC_BWD - before == \
        2 * cuda_acoustic.launches_backward_acoustic(cfg, rs)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    ref = cuda_acoustic.backward_plain_acoustic(cfg, rs, *res)
    assert all(float(a.abs().max()) > 0 for a in ref)
    err = grad_errors(out, ref, cfg, AC_INTERIOR)
    assert max(err) < GRAD_TOL, err
    _, _, gap = adjoint_gap(cfg, rs, args, TILE_EDGE_SEED)
    assert gap <= DOT_TOL
    lam, rho, stf, src_z, src_x = args
    vp = torch.sqrt(lam / rho).contiguous()
    img, ill = cuda_acoustic.image_cuda_acoustic_plan(
        plan, vp, rho, stf, src_z, src_x, final, strips, -cot)
    img_p, ill_p = cuda_acoustic.rtm_image_time_plain(
        cfg, rs, vp, rho, stf, src_z, src_x, -cot)
    assert float(img_p.abs().max()) > 0 and float(ill_p.max()) > 0
    assert max_rel(img, img_p) < GRAD_TOL and max_rel(ill, ill_p) < GRAD_TOL


@pytest.mark.parametrize("case", ["reference shape nt=301", "small ezz"])
def test_illumination_kernel_bitwise(cuda, case):
    """illumination_cuda_plan (the fused elastic step with its illumination
    accumulator, one launch a step) bitwise equal to
    imaging.source_illumination on the card, shot by shot."""
    cfg, rs, args = row_problem(*ROW_CASES[case], device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    before = cuda_engine.LAUNCHES_ILL
    ill = cuda_engine.illumination_cuda_plan(plan, *args)
    torch.cuda.synchronize()
    assert cuda_engine.LAUNCHES_ILL - before == cfg.nt - 1
    lam, mu, rho, stf, src_z, src_x, rxz = args
    geoms = cuda_engine._geoms(cfg, rs, src_z, src_x, rxz, lam.device,
                               lam.dtype)
    ref = imaging.source_illumination(cfg, lam, mu, rho, stf, geoms)
    assert float(ref.max()) > 0
    assert torch.equal(ill, ref)


@pytest.mark.parametrize("case", ["points by a neighbour's halo",
                                  "ragged tiles"])
def test_acoustic_backward_refuses_a_table_of_other_tiles(cuda, case,
                                                          monkeypatch):
    """A plan whose injection rows by tile were built for tiles other than
    the kernel's makes acoustic_backward raise before any launch, for
    points and for a row."""
    cfg, rs, args = ac_tile_edge_problem(case, device=cuda)
    syn, strips, final = cuda_acoustic.forward_cuda_acoustic_plan(
        cuda_engine.plan_for(cfg, rs), *args, save_strips=True)
    monkeypatch.setattr(cuda_engine, "TILE", (8, 32))
    plan = cuda_engine.FastPlan(cfg, rs)   # not the cached plan
    before = cuda_acoustic.LAUNCHES_AC_BWD
    with pytest.raises(RuntimeError, match="other tiles"):
        cuda_acoustic.backward_cuda_acoustic_plan(plan, *args, final, strips,
                                                  syn)
    assert cuda_acoustic.LAUNCHES_AC_BWD == before


@pytest.mark.parametrize("case", AC_POINT_CASES)
def test_acoustic_points_backward_and_image(cuda, case):
    """The acoustic backward and its imaging variant with point receivers,
    whose cotangents the fused reverse step adds itself: nt launches each
    (LAUNCHES_AC_BWD, LAUNCHES_AC_IMG), gradients on the tight interior less
    2 and the image and illumination within GRAD_TOL of plain, and a second
    run of each bitwise equal."""
    cfg, rs, args = _ac_point_problem(case, cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    syn, strips, final = cuda_acoustic.forward_cuda_acoustic_plan(
        plan, *args, save_strips=True)
    cot = ac_perturbed_cotangent(cfg, rs, args, syn)
    res = (*args, final, strips, cot)
    before = cuda_acoustic.LAUNCHES_AC_BWD
    out = cuda_acoustic.backward_cuda_acoustic_plan(plan, *res)
    torch.cuda.synchronize()
    assert cuda_acoustic.LAUNCHES_AC_BWD - before == cfg.nt
    again = cuda_acoustic.backward_cuda_acoustic_plan(plan, *res)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    ref = cuda_acoustic.backward_plain_acoustic(cfg, rs, *res)
    assert all(float(a.abs().max()) > 0 for a in ref)
    err = grad_errors(out, ref, cfg, AC_INTERIOR)
    assert max(err) < GRAD_TOL, err

    lam, rho, stf, src_z, src_x = args
    vp = torch.sqrt(lam / rho).contiguous()
    image = lambda: cuda_acoustic.image_cuda_acoustic_plan(
        plan, vp, rho, stf, src_z, src_x, final, strips, -cot)
    before = (cuda_acoustic.LAUNCHES_AC_BWD, cuda_acoustic.LAUNCHES_AC_IMG)
    img, ill = image()
    torch.cuda.synchronize()
    assert (cuda_acoustic.LAUNCHES_AC_BWD - before[0],
            cuda_acoustic.LAUNCHES_AC_IMG - before[1]) == (cfg.nt, cfg.nt)
    again = image()
    assert torch.equal(again[0], img) and torch.equal(again[1], ill)
    img_p, ill_p = cuda_acoustic.rtm_image_time_plain(
        cfg, rs, vp, rho, stf, src_z, src_x, -cot)
    assert float(img_p.abs().max()) > 0 and float(ill_p.max()) > 0
    assert max_rel(img, img_p) < GRAD_TOL and max_rel(ill, ill_p) < GRAD_TOL


# (shots, nz, nx, offset of the planes in floats): a per-shot stride of
# 5 nz nx floats that is not a multiple of 4 (the reference workload's
# 218,625; a tiny grid whose last tile is ragged), one that is (and the
# same planes one float off 16-byte alignment), and the Marmousi-scale
# chunk of 2 shots, whose grid strides over many tiles.
SUM_CASES = {"reference workload": (19, 165, 265, 0),
             "tiny, ragged": (5, 7, 9, 0),
             "aligned": (2, 64, 96, 0),
             "aligned stride, planes off 16 bytes": (3, 64, 96, 1),
             "814x2064, 2 shots": (2, 814, 2064, 0)}


@pytest.mark.parametrize("case", SUM_CASES)
def test_elastic_sum_shots_bitwise(cuda, case):
    """sum_shots_kernel (through elastic_sum_shots) bitwise equal to a
    plain loop over shots in shot order, the float4 variant and the 4-byte
    one alike."""
    S, nz, nx, off = SUM_CASES[case]
    n = 5 * nz * nx
    gen = torch.Generator(device=cuda).manual_seed(22)
    buf = torch.randn(off + S * n, generator=gen, device=cuda)
    per_shot = buf[off:].view(S, 5, nz, nx)
    out_buf = torch.full((off + n,), float("nan"), device=cuda)
    out = out_buf[off:].view(5, nz, nx)
    lib = _build.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.elastic_sum_shots(per_shot.data_ptr(), out.data_ptr(), S, nz,
                                 nx, stream) == 0
    ref = torch.zeros_like(out)
    for k in range(S):
        ref += per_shot[k]
    assert torch.equal(out, ref)


# (shots, planes a shot, nz, nx, offset of the planes in floats): the
# reference workload's gradient (19 x 3 planes) and rtm image (19 x 2),
# whose per-shot strides are not multiples of 4 floats; a tiny grid with a
# ragged last tile; more shots than a thread loads before it adds; the
# one-shot gradient at 814x2064 and a 12-shot sum whose strides are (the
# float4 variant, few shots and many), each also with the planes one float
# off 16-byte alignment.
AC_SUM_CASES = {"reference workload": (19, 3, 165, 265, 0),
                "rtm image": (19, 2, 165, 265, 0),
                "reference, planes off 16 bytes": (19, 3, 165, 265, 1),
                "tiny, ragged": (5, 3, 7, 9, 0),
                "40 shots": (40, 2, 30, 50, 0),
                "814x2064, 1 shot": (1, 3, 814, 2064, 0),
                "814x2064, planes off 16 bytes": (1, 3, 814, 2064, 1),
                "12 shots of 300x400": (12, 3, 300, 400, 0),
                "12 shots of 300x400, planes off 16 bytes":
                    (12, 3, 300, 400, 1)}


@pytest.mark.parametrize("case", AC_SUM_CASES)
def test_acoustic_sum_shots_bitwise(cuda, case):
    """ac_sum_shots_kernel (through acoustic_sum_shots) bitwise equal to a
    plain loop over shots in shot order, for few shots and many, the float4
    variant and the 4-byte one alike; nothing past the sum is written."""
    S, planes, nz, nx, off = AC_SUM_CASES[case]
    n = planes * nz * nx
    gen = torch.Generator(device=cuda).manual_seed(22)
    buf = torch.randn(off + S * n, generator=gen, device=cuda)
    per_shot = buf[off:].view(S, planes, nz, nx)
    out_buf = torch.full((off + n + 4,), float("nan"), device=cuda)
    out = out_buf[off:off + n].view(planes, nz, nx)
    lib = _build.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.acoustic_sum_shots(per_shot.data_ptr(), out.data_ptr(), S,
                                  planes, nz, nx, stream) == 0
    ref = torch.zeros_like(out)
    for k in range(S):
        ref += per_shot[k]
    assert torch.equal(out, ref)
    assert bool(out_buf[off + n:].isnan().all())


@pytest.mark.parametrize("n_shards,chunk", [(2, 0), (3, 2)],
                         ids=["2 shards", "3 shards chunked by 2"])
def test_sharded_gradient_matches_unsharded(cuda, n_shards, chunk):
    """make_cuda_sharded_misfit over a mesh that repeats the card, the 9
    shots padded to a multiple of it, against make_cuda_misfit unsharded
    (phase 29 of chip_smoke.py): the loss within 1e-6, the gradients of
    lam, mu, rho and stf within 2e-5 of each one's max, per shard and chunk
    nt forward launches with strips and nt backward launches, no plain
    call, and a second evaluation bitwise equal to the first."""
    cfg, survey, _, stf = cli.benchmark_problem(nz=61, nx=101, nt=601,
                                                device=cuda)
    vp, vs, rho = models.anomaly_vp_vs_rho(61, 101)
    pad = lambda a: torch.as_tensor(medium.pad_model_np(a, cfg.npml),
                                    device=cuda).float()
    lam, mu, rho = (a.contiguous() for a in
                    medium.Medium(pad(vp), pad(vs), pad(rho)).to_lame())
    stf = stf.contiguous()
    S = survey.n_shots
    obs = parallel.make_forward(cfg, survey, use_kernels=True, device=cuda)(
        (lam * 1.03).contiguous(), mu, rho, stf)
    w = torch.ones(S, device=cuda)

    def value_and_grad(loss, obs, w, n_pad=0):
        p = [a.clone().requires_grad_() for a in (lam, mu, rho, stf)]
        val = loss(*p[:3], parallel._pad_rows(p[3], n_pad), obs, w)
        return val.detach(), torch.autograd.grad(val, p)

    ref_val, ref_grads = value_and_grad(
        parallel.make_cuda_misfit(cfg, survey), obs, w)
    mesh = (cuda,) * n_shards
    geoms = parallel.survey_to_geoms(survey, cfg.npml, device=cuda)
    _, _, obs_p, w_p, _ = parallel.pad_shots(stf, geoms, obs, w, n_shards)
    survey_p = parallel.pad_survey(survey, n_shards)
    loss = parallel.make_cuda_sharded_misfit(cfg, survey_p, mesh,
                                             shot_chunk=chunk)
    n_pad = survey_p.n_shots - S
    before = (cuda_engine.LAUNCHES_STRIPS, cuda_engine.LAUNCHES_BWD,
              sum(cuda_engine.PLAIN_CALLS.values()))
    val, grads = value_and_grad(loss, obs_p, w_p, n_pad)
    torch.cuda.synchronize()
    chunks = len(parallel._chunks(survey_p.n_shots // n_shards, chunk))
    assert (cuda_engine.LAUNCHES_STRIPS - before[0],
            cuda_engine.LAUNCHES_BWD - before[1],
            sum(cuda_engine.PLAIN_CALLS.values()) - before[2]) == (
        cfg.nt * n_shards * chunks, cfg.nt * n_shards * chunks, 0)
    assert float((val - ref_val).abs() / ref_val.abs()) <= 1e-6
    for name, a, b in zip(("lam", "mu", "rho", "stf"), grads, ref_grads):
        assert float(b.abs().max()) > 0, name
        assert float((a - b).abs().max() / b.abs().max()) <= 2e-5, name
    val2, grads2 = value_and_grad(loss, obs_p, w_p, n_pad)
    assert torch.equal(val, val2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


def _launches():
    return (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_BWD,
            cuda_acoustic.LAUNCHES_AC, cuda_acoustic.LAUNCHES_AC_BWD)


def test_invert_x64_on_the_card_matches_cpu(cuda, tmp_path, capsys):
    """`invert --x64 --device cuda` runs the plain version in float64 on
    the card (the engine line names it, the plain propagator is called, no
    kernel launches) and gives --device cpu's loss.txt and model to 1e-9
    relative (phase 30 of chip_smoke.py)."""
    before = (_launches(), cuda_engine.PLAIN_CALLS["propagate"])
    card = invert_run([*TINY_INVERT, "--x64"], str(tmp_path / "card"))
    out = capsys.readouterr().out
    assert "engine: plain PyTorch (cuda:0, float64)" in out
    assert _launches() == before[0]
    assert cuda_engine.PLAIN_CALLS["propagate"] > before[1]
    cpu = invert_run([*TINY_INVERT, "--x64", "--device", "cpu"],
                     str(tmp_path / "cpu"))
    assert card[0].shape == cpu[0].shape and len(card[0]) >= 1
    assert rel_diff(card[0][:, 1], cpu[0][:, 1]) <= PLAIN_DEVICE_TOL
    assert card[1].keys() == cpu[1].keys()
    for k in cpu[1]:
        assert rel_diff(card[1][k], cpu[1][k]) <= PLAIN_DEVICE_TOL, k


def test_api_float64_on_the_card_matches_cpu(cuda):
    """ElasticPropagator(dtype=torch.float64, device='cuda') runs the plain
    propagator on the card (the JAX API's XLA path): apply_gradient equals
    device='cpu''s to 1e-9 relative, with no kernel launch (phase 30)."""
    model, survey, init = api_problem()
    obs = api.ElasticPropagator(model, survey, device="cpu",
                                dtype=torch.float64).apply_forward()
    before = _launches()
    card = api.ElasticPropagator(model, survey, device=cuda,
                                 dtype=torch.float64)
    assert card.rs is None
    got = card.apply_gradient(init, obs)
    assert _launches() == before
    ref = api.ElasticPropagator(model, survey, device="cpu",
                                dtype=torch.float64).apply_gradient(init, obs)
    assert got["misfit"] > 0
    assert abs(got["misfit"] - ref["misfit"]) <= \
        PLAIN_DEVICE_TOL * ref["misfit"]
    for k in ("grad_vp", "grad_vs", "grad_rho", "grad_stf"):
        assert rel_diff(got[k], ref[k]) <= PLAIN_DEVICE_TOL, k


def test_unplanned_survey_on_the_card_matches_cpu(cuda, tmp_path, capsys,
                                                  monkeypatch):
    """A survey no plan takes (`corner_survey`), which the JAX package runs
    on its XLA engine (phase 30d): on the card `invert` in float32 under
    --engine auto and pallas and ElasticPropagator's default engine raise
    before anything runs, naming the plain engine; `invert --engine xla` at
    CORNER_INVERT's size (where float32 L-BFGS-B takes steps) names cuda:0
    and float32, makes no kernel launch and gives --device cpu's loss.txt
    and model to 1e-6 relative; with --n-devices 2 over a mesh that
    repeats the card it gives its loss at the starting model to 1e-6;
    ElasticPropagator(device='cuda', engine='xla') gives device='cpu''s
    data, misfit and gradients to 1e-6."""
    tol = PLAIN_F32_DEVICE_TOL
    path = str(tmp_path / "corners.json")
    corner_survey(44, 64).to_json(path)
    argv = [*CORNER_INVERT, "--survey-json", path]
    monkeypatch.setattr(parallel, "shot_mesh", repeated_shot_mesh)
    model, survey, init = corner_api_problem()
    before = (_launches(), cuda_engine.PLAIN_CALLS["propagate"])
    for flags in ([], ["--engine", "pallas"]):
        with pytest.raises(ValueError, match="--engine xla runs it"):
            invert_run([*argv, *flags], str(tmp_path / "refused"))
    with pytest.raises(ValueError, match="engine='xla'"):
        api.ElasticPropagator(model, survey, device=cuda)
    assert (_launches(), cuda_engine.PLAIN_CALLS["propagate"]) == before

    xla = [*argv, "--engine", "xla"]
    card = invert_run(xla, str(tmp_path / "card"))
    assert "engine: plain PyTorch (cuda:0, float32)" in capsys.readouterr().out
    assert _launches() == before[0]
    assert cuda_engine.PLAIN_CALLS["propagate"] > before[1]
    cpu = invert_run([*xla, "--device", "cpu"], str(tmp_path / "cpu"))
    assert card[0].shape == cpu[0].shape and len(card[0]) >= 1
    assert rel_diff(card[0][:, 1], cpu[0][:, 1]) <= tol
    for k in cpu[1]:
        assert rel_diff(card[1][k], cpu[1][k]) <= tol, k
    sharded = invert_run([*xla, "--n-devices", "2"], str(tmp_path / "mesh"))
    out = capsys.readouterr().out
    assert "engine: plain PyTorch (cuda:0, float32)" in out
    assert "multi-chip: 2-device shot mesh" in out
    assert sharded[0].shape == card[0].shape
    assert sharded[0][-1, 1] < sharded[0][0, 1]
    # the sharded loss adds its shots in another order: held at the
    # starting model, not along L-BFGS-B's iterates
    assert rel_diff(sharded[0][0, 1], card[0][0, 1]) <= tol
    assert _launches() == before[0]

    prop = api.ElasticPropagator(model, survey, device=cuda, engine="xla")
    assert prop.rs is None
    obs = prop.apply_forward()
    got = prop.apply_gradient(init, obs)
    assert _launches() == before[0]
    ref_prop = api.ElasticPropagator(model, survey, device="cpu")
    assert rel_diff(obs, ref_prop.apply_forward()) <= tol
    ref = ref_prop.apply_gradient(init, obs)
    assert got["misfit"] > 0
    assert abs(got["misfit"] - ref["misfit"]) <= tol * ref["misfit"]
    for k in ("grad_vp", "grad_vs", "grad_rho", "grad_stf"):
        assert rel_diff(got[k], ref[k]) <= tol, k
