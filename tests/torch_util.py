"""Shared set-up of the port's test files (tests/test_torch_*.py).

The suite runs in several worker processes at once; PyTorch's CPU ops
would each take every core, so the port's tests run on one thread.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
