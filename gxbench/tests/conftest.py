"""Shared fixture of the benchmark's CPU tests: one torch thread a worker,
so that several pytest workers on one host do not oversubscribe it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
