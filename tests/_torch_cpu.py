"""Shared fixture of the port's CPU tests.

The suite runs several pytest workers on one host. torch's intra-op
thread pool in each of them would oversubscribe the cores, and its
spinning threads then slow every small operator of the plain wavefronts
by orders of magnitude; one thread per worker keeps them fast.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
