"""One torch intra-op thread for the port's test files.

The port's CPU runs in these tests are many small tensor operations, and
the suite runs six test workers at once on the host's cores: a team of
intra-op threads per process only spins against the other workers (an
OpenMP team waits busy after each parallel region), which took files
several times their standalone time. Each test_torch_*.py imports
`one_torch_thread`, an autouse fixture that holds torch at one intra-op
thread for the module and gives the worker its setting back after it;
the subprocesses the tests start take ONE_THREAD_ENV. No result depends
on the thread count: every comparison is of integers.
"""

import os

import pytest
import torch

ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def one_thread_env() -> dict:
    """os.environ with ONE_THREAD_ENV, for a subprocess that runs torch."""
    return {**os.environ, **ONE_THREAD_ENV}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
