"""One intra-op thread for the port's test modules.

SMOKE shapes gain nothing from intra-op threads, and in a run of the
suite over several processes those threads oversubscribe the cores (each
process would start one a core).  A test module takes the fixture by
importing it:

    from _torch_threads import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
