"""Shared by the port's CPU tests of whole examples and optimizer runs:
torch's intra-op threads capped for a module's tests, then restored.  Their
tensors are small (a few shots of about 100x100), so more threads cost more
than they give, the more so when other test workers share the cores.  Not a
test module itself; a test module takes the fixture by importing it:

    from torch_threads import one_thread  # noqa: F401  (autouse)
"""
import pytest
import torch


def _capped(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from _capped(1)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    yield from _capped(2)
