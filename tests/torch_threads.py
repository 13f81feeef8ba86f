"""An autouse fixture for the torch-heavy test files: one torch
intra-op thread a test, the count put back after it.

Torch's default is an intra-op thread a core.  With several pytest
workers (`-n 6`) their pools oversubscribe the cores, and a file of
large torch ops runs tens of times slower than alone.  The codec's
results do not depend on the thread count."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
