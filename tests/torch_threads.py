"""One torch thread for the port's CPU tests.

The port's tests run on small lattices, where torch's intra-op threads
gain nothing, and the suite runs as several pytest-xdist workers on one
machine: a worker whose torch keeps a thread per core competes with the
others for every core.  Each ``tests/test_torch_*.py`` imports the
autouse fixture below, which sets one torch thread for its module and
restores the setting after.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
