"""One torch thread for the port's CPU tests.

The port's steps on small problems are long loops of small products.
One torch thread runs them as fast as eight, and leaves the cores to the
suite's other workers: with six workers of eight threads each on eight
cores, such loops slow down many times over. A test module takes the
fixture by importing it::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's tests on one torch thread, then restore the
    count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
