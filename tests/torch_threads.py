"""A module-scoped autouse fixture for the port's CPU tests: import it into
a test module (`from tests.torch_threads import one_torch_thread`) and the
module runs with one PyTorch intra-op thread, restored afterwards. Where
every core is busy (the suite run by several pytest-xdist workers),
PyTorch's thread pool runs these small graphs several times slower than
one thread does: one train step of the scale-n graph at 64 px took 2.3 s
with 8 threads and 0.19 s with one on an 8-core CPU whose cores were all
busy with the suite."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
