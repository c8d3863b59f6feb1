"""One PyTorch thread for the port's CPU tests.

The tests run in several worker processes at once, and each PyTorch process
starts an OpenMP pool as wide as the machine: six workers keep ~50 threads
busy on 8 cores, and every small operator then waits on its pool.  Held to
one thread a worker, ``tests/test_torch_*.py`` under ``-n 6 --dist
loadfile`` took 243 s on an 8-core host where they took 759 s.  A test
module imports the fixture below, which applies to its tests alone and
restores the process's thread count after them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
