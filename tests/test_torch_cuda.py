"""The CUDA kernels against their plain PyTorch versions on the card, float32:
the forward (2e-5 of each channel's max), the forward with boundary strips
(data, strips and final fields to 2e-5), the boundary-saving adjoint
(5e-4 of each gradient's max, the same bits on a second run), the adjoint
dot product (5e-5) and the reconstruction (at most 10x the plain
residual), on receiver rows (ROW_CASES) and on point receivers
(FIBER_CASES: a weighted arc fiber, a column, duplicate points); and the
acoustic kernels on AC_CASES (a row, duplicate points, a column) to the same
tolerances, with the image and illumination of the imaging variant (5e-4).
These mirror phases 3, 7-10, 12 and 17 of chip_smoke.py; they need a CUDA
device and nvcc, and skip without a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from sep2023_tpu_torch.ops import cuda_acoustic, cuda_engine
from sep2023_tpu_torch.testing import (AC_CASES, AC_INTERIOR, DOT_TOL,
                                       FIBER_CASES, FWD_TOL, GRAD_TOL,
                                       RECON_RATIO, ROW_CASES,
                                       ac_perturbed_cotangent, ac_problem,
                                       adjoint_gap, fiber_problem,
                                       grad_errors, max_rel,
                                       perturbed_cotangent,
                                       reconstruction_residual, row_problem,
                                       strip_errors)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _compare(cfg, rs, args, tol):
    before = cuda_engine.LAUNCHES
    out = cuda_engine.forward_cuda_plan(cuda_engine.plan_for(cfg, rs), *args)
    torch.cuda.synchronize()
    assert cuda_engine.LAUNCHES - before == 3 * (cfg.nt - 1)
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
    steps = 3 * (cfg.nt - 1)
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
    assert cuda_engine.LAUNCHES_BWD - before == 2 * (2 * (cfg.nt - 1) + 1)
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
    """record_points_kernel: data, strips and final fields, and one point
    launch a step."""
    cfg, rs, args = fiber_problem(case, device=cuda)
    before = (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_FIBER)
    out = cuda_engine.forward_cuda_plan(cuda_engine.plan_for(cfg, rs), *args,
                                        save_strips=True)
    torch.cuda.synchronize()
    steps = cfg.nt - 1
    assert (cuda_engine.LAUNCHES, cuda_engine.LAUNCHES_FIBER) == \
        (before[0] + 3 * steps, before[1] + steps)
    ref = cuda_engine.forward_plain_strips(cfg, rs, *args)
    assert float(ref[0][:, 3].abs().max()) > 1e-3
    d, s, f = strip_errors(out, ref)
    assert max(d + s + f) < FWD_TOL, (d, s, f)


@pytest.mark.parametrize("case", list(FIBER_CASES))
def test_fiber_backward_matches_plain(cuda, case):
    """inject_points_kernel inside the backward: gradients, the same bits on
    a second run, one injection launch a step, and the adjoint identity."""
    cfg, rs, args = fiber_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    syn, strips, final = cuda_engine.forward_cuda_plan(plan, *args,
                                                       save_strips=True)
    res = (*args, final, strips, perturbed_cotangent(cfg, rs, args, syn))
    before = (cuda_engine.LAUNCHES_BWD, cuda_engine.LAUNCHES_BWD_FIBER)
    out = cuda_engine.backward_cuda_plan(plan, *res)
    again = cuda_engine.backward_cuda_plan(plan, *res)
    torch.cuda.synchronize()
    steps = cfg.nt - 1
    assert (cuda_engine.LAUNCHES_BWD, cuda_engine.LAUNCHES_BWD_FIBER) == \
        (before[0] + 2 * (3 * steps + 1), before[1] + 2 * steps)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    err = grad_errors(out, cuda_engine.backward_plain(cfg, rs, *res), cfg)
    assert max(err) < GRAD_TOL, err
    _, _, gap = adjoint_gap(cfg, rs, args)
    assert gap <= DOT_TOL


@pytest.mark.parametrize("case", list(AC_CASES))
def test_acoustic_forward_matches_plain(cuda, case):
    """acoustic_forward with and without strips: data, strips and final
    fields (2e-5), three launches a step, the same data either way."""
    cfg, rs, args = ac_problem(case, device=cuda)
    plan = cuda_engine.plan_for(cfg, rs)
    before = (cuda_acoustic.LAUNCHES_AC, cuda_acoustic.LAUNCHES_AC_STRIPS)
    out = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args,
                                                   save_strips=True)
    data = cuda_acoustic.forward_cuda_acoustic_plan(plan, *args)
    torch.cuda.synchronize()
    steps = 3 * (cfg.nt - 1)
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
