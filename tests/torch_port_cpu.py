"""The CPU-thread rule of the port's tests (`tests/test_torch_port_*.py`).

Every port test file imports the fixture below by name:

    from torch_port_cpu import one_intra_op_thread  # noqa: F401

and so runs on one intra-op thread. The port's tests are mostly loops of
small tensors, which gain little from more threads, while torch's pool of
busy-waiting threads on cores that other test workers share slows a file
many-fold: the n-body CLI tests took minutes beside five busy workers at
the default count, and seconds at one. `tests/test_torch_port_surface.py`
checks that every port file imports the fixture and that none sets the
count itself.

The count is restored when the file ends: under `--dist loadfile` one
worker process runs several files, and the JAX package's files keep the
count they start with. Child processes a test starts are not covered
here; those tests pass their own counts (`threads=` of `parallel.spawn`,
`OMP_NUM_THREADS`).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the importing test file, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
