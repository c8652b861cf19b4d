"""The thread rule of the port's CPU tests: one thread a worker.

The suite runs under several xdist workers, one process each, and each
process's torch, BLAS and OpenMP pools would otherwise start a thread on
every core: six workers then keep up to six times as many busy threads as
the machine has cores, and a test whose pools spin at their barriers (an
sklearn t-SNE of 12 points, a small InceptionV3) takes minutes instead of
seconds. Every port test module that runs on the CPU takes the rule by
importing the fixture, which pytest then finds in the module's namespace::

    from torch_threads import one_thread  # noqa: F401

``tests/test_torch_threads.py`` checks that each such module does, but
those its ``DEFAULT_THREADS`` names with the reason, and that a test inside
one sees one thread in every pool. The rule does not reach the processes a
test starts: ``parallel.multiprocess`` gives each rank its own."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Cap torch's intra-op threads and every OpenMP and BLAS pool of the
    process at one for the module's tests, then restore both, so that the
    modules the same worker runs next see the process as before.

    A pool caps only once its library is loaded, and sklearn loads its own
    OpenMP runtime and scipy's OpenBLAS at its first import, which the
    port's code makes inside the functions that use it: the fixture imports
    sklearn first, where it is installed, so that the cap reaches them."""
    from threadpoolctl import threadpool_limits

    try:
        import sklearn  # noqa: F401
    except ImportError:
        pass
    threads = torch.get_num_threads()
    with threadpool_limits(limits=1):
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)
