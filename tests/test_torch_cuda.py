"""The CUDA kernels against their plain PyTorch versions on the card, float32:
the forward (2e-5 of each channel's max), the forward with boundary strips
(data, strips and final fields to 2e-5), the boundary-saving adjoint
(5e-4 of each gradient's max, the same bits on a second run), the adjoint
dot product (5e-5) and the reconstruction (at most 10x the plain
residual).  These mirror phases 3 and 7-10 of chip_smoke.py; they need a
CUDA device and nvcc, and skip without a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.testing import (DOT_TOL, FWD_TOL, GRAD_TOL,
                                       RECON_RATIO, ROW_CASES, adjoint_gap,
                                       grad_errors, perturbed_cotangent,
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
    out = cuda_engine.forward_cuda(cfg, rs, *args)
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
    out = cuda_engine.forward_cuda(cfg, rs, *args, save_strips=True)
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
    syn, strips, final = cuda_engine.forward_cuda(cfg, rs, *args,
                                                  save_strips=True)
    assert float(syn[:, 3].abs().max()) > 1e-3
    res = (*args, final, strips, perturbed_cotangent(cfg, rs, args, syn))
    before = cuda_engine.LAUNCHES_BWD
    out = cuda_engine.backward_cuda(cfg, rs, *res)
    again = cuda_engine.backward_cuda(cfg, rs, *res)
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
    data, strips, final = cuda_engine.forward_cuda(cfg, rs, *args,
                                                   save_strips=True)
    kern = reconstruction_residual(cfg, cuda_engine.reconstruct_cuda(
        cfg, rs, *args, final, strips), data)
    plain = reconstruction_residual(cfg, cuda_engine.reconstruct_plain(
        cfg, rs, *args, final, strips), data)
    assert np.isfinite(kern) and kern <= RECON_RATIO * plain, (kern, plain)
