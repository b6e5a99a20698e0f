"""The benchmark's CPU tests run PyTorch on one thread: six test workers
with a thread pool each would spin against each other, and every test
here times or waits on whole runs."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
