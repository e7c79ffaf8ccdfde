"""Small helpers the drivers and tools share."""

from __future__ import annotations

import importlib
from typing import List

import numpy as np
import torch


def sync(device) -> None:
    """Wait for the card (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def child_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent seeds drawn from ``seed`` (any size of integer)."""
    return [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(n)]


def make_pool(traffic: dict, seed: int, device):
    """The pool of the traffic's generator, ``benchmark/traffic/<generator>.py``."""
    return importlib.import_module(f"traffic.{traffic['generator']}").make_pool(
        traffic, seed, device)
