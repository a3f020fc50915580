"""``one_torch_thread``: an autouse fixture for the port's test files that
run many small torch ops (the CPU traversal strategies, the sharded
renders). Import it into a test module to pin torch to one intra-op thread
for that module's tests: the tests run beside other test workers, and
torch's thread pool turns each small op into a wait for cores that are
busy (a 0.8 s case took 119 s in a six-worker run)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
