"""One CPU thread a test for the port's CPU tests.

The tier-1 command runs six pytest workers on one machine. In every worker
PyTorch's OpenMP pool and numpy's OpenBLAS pool each start a thread per
core, and idle threads spin before they sleep, so six workers oversubscribe
the cores many times over: ``tests/test_torch_int8_conv.py -k
wgmma_schedule`` passes its 6 cases in 28 s alone, while six copies at
once passed 2 each in 600 s. Every ``tests/test_torch_*.py`` that runs on
the CPU imports :func:`one_cpu_thread`, an autouse fixture of module
scope, so that it also covers the module's own module-scoped fixtures
(databases, trained checkpoints): the module's tests run with one
intra-op thread and one BLAS thread, their child processes inherit
``OMP_NUM_THREADS=1`` and ``OPENBLAS_NUM_THREADS=1``, and the counts are
restored after the module. The tensors here are small, so one thread is
also about as fast alone. (``tests/test_torch_cuda.py`` runs on the
card's machine, without ``threadpoolctl``, and does not import it.)
"""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp, threadpool_limits(limits=1):
            mp.setenv("OMP_NUM_THREADS", "1")
            mp.setenv("OPENBLAS_NUM_THREADS", "1")
            yield
    finally:
        torch.set_num_threads(n)
