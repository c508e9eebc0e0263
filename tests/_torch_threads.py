"""The port's tests that train or launch ranks run on one intra-op thread: the test workers
share the host's cores, and torch's pool of intra-op threads, waiting at each op for
threads that other workers hold, made those tests tens of times slower than alone.

A test module opts in with ``from _torch_threads import one_intra_op_thread``: importing
an autouse fixture into a module registers it there.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
