"""Shared by the port's CPU tests (``tests/test_torch_*.py``): each of
their modules imports :func:`one_torch_thread`, an autouse fixture that
runs torch on one intra-op thread while the module's tests run.

Their tensors are small, and the tier-1 run spreads the test files over
six pytest-xdist workers on the host's cores. With torch's default of one
thread per core, every worker's parallel regions wait on threads that
the other workers hold, and the small kernels spend most of their time
waiting: on an 8-core host the whole six-worker run took 870 s with
torch's default threads and 476 s with one thread a worker."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
