"""An autouse fixture that runs a test module's tests with one torch
intra-op thread. The suite runs several pytest workers at once on the
host's cores, and torch's default of one thread per core in each worker
oversubscribes them: the port's many small ops then wait on the thread
pool (a file of them took 5-30x its one-process time). Import it into a
test module to apply it there; the tests' checks and tolerances are
their own."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
