"""The CUDA forward kernel against its plain PyTorch version on the card
(float32, 2e-5 of each channel's max).  These mirror phase 3 of
chip_smoke.py; they need a CUDA device and nvcc, and skip without a card:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from sep2023_tpu_torch.ops import cuda_engine
from sep2023_tpu_torch.testing import ROW_CASES, row_problem

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
