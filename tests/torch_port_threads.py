"""One torch intra-op thread for the port's CPU tests.

The suite runs test files side by side in several processes (``-n 6
--dist loadfile``).  With torch's default of one intra-op thread per core,
each torch product in one process waits on cores that the other processes
hold, and its spinning threads slow the files beside it, most of all the
reference's multi-process server tests.  Every ``tests/test_torch_port_*``
file that computes on the CPU imports this fixture; the worker scripts
they start set one thread themselves.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
