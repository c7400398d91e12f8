"""One torch thread for each test module of the port, and for the processes
its tests start.

The suite runs on several pytest-xdist workers at once. Left alone, each
worker's torch takes as many intra-op threads as the host has cores, and
the workers together oversubscribe the host many times over: a check
that takes under a minute alone then takes many times that. Each
`tests/test_torch_*.py` imports `one_torch_thread` (autouse, module
scope, so it also covers the module's own fixtures), and a subprocess
that a test starts takes `child_env()`.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def child_env(**extra) -> dict:
    """This process's environment for a child: without PYTHONPATH (the child
    runs from the repository root) and with one OpenMP thread."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env
