"""A module fixture for the port's CPU tests: torch's intra-op pool held
at one thread while a test module runs, and given back after.  The suite
runs six workers side by side (``-n 6``, beside the reference's
subprocesses): the port's loops over small tensors gain nothing from a
pool the size of the machine, whose idle threads spin against the other
workers' (with one thread a test module of the engine runs about ten
times faster in a full run).  Import it into a test module:
``from torch_threads import one_thread  # noqa: F401``."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
