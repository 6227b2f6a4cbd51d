"""One fixture that the port's test modules share: each module's torch
work runs on TORCH_THREADS intra-op threads.

The suite runs 6 xdist workers on 8 CPUs; with torch's default of one
thread per CPU in every worker, 48 threads besides XLA's contend for the
cores. Import it into a test module (``from torch_threads import
torch_threads  # noqa: F401``): pytest then uses the autouse fixture for
that module.
"""

import pytest
import torch

TORCH_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)
