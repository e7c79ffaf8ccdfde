"""The benchmark's own tests: CPU only, small shapes, the card's tests
marked ``cuda``. ``python -m pytest benchmark/tests`` from the root of a
checkout."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    yield
