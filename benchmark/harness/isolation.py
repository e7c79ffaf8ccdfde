"""What a run may load and where it may write.

The benchmark measures the PyTorch port alone: once the window has
closed, no module of JAX or of the JAX package may be loaded in the
process. Names are compared by their top-level part whole, so
``tpuseg_torch`` is not ``tpuseg``.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "tpuseg")


def forbidden_modules(names: Iterable[str] = None, forbidden=FORBIDDEN) -> List[str]:
    """Sorted top-level names among ``names`` (default ``sys.modules``)
    that are in ``forbidden``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(forbidden))


def prepare_environment(root: str) -> None:
    """Keep every kernel cache at a fixed path inside the checkout (the
    port's own libraries already build into ``<root>/build``), keep
    libraries from loading JAX on their own, and give the host few threads
    so that a run's load is one steady process."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "4")
