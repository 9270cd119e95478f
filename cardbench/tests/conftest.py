import pytest
import torch


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The benchmark's CPU tests run their small products on one thread:
    beside the other test workers, a pool of threads a worker only
    contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
