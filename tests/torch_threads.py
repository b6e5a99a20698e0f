"""An autouse fixture for the LM test modules (imported by them): PyTorch on
one thread while a module runs, the count restored after."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs one module a worker on several workers; PyTorch's
    thread pool on every core of each worker then spins against the others
    (a 40-step training run on the CPU took 396 s in the suite, 9 s alone
    on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
