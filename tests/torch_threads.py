"""One PyTorch intra-op thread for the port's CPU tests.

The test runner starts several worker processes on one machine's cores.
Each PyTorch process would otherwise start one intra-op thread per core,
and the plain twins' many small operations then wait on threads that the
other workers' threads crowd out: on a loaded 8-core machine one harness
test ran 13 times slower with 8 threads than with 1.  Results do not
depend on the thread count.  A test module takes the fixture by importing
it: ``from torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
