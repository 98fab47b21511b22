"""One torch thread for the port's CPU tests.

The suite runs in several worker processes on a machine of few cores.
Left to itself, torch gives each process as many threads as the machine has
cores, and the workers' threads then wait on each other: the port's test
files took twice as long in six workers as they take with a thread each.
Each of them imports `one_torch_thread`, a module-scoped autouse fixture,
and passes `one_thread_env()` to the interpreters it starts."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def one_thread_env():
    """The environment for a child interpreter: one OpenMP thread."""
    return dict(os.environ, OMP_NUM_THREADS="1")
