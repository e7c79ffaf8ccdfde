"""Throughput telemetry for the trainer.

The port's copy of ``ThroughputMeter`` from ``tpuseg/utils/profiling.py``.
The trainer calls :meth:`ThroughputMeter.update` right after reading the
window's loss back from the card, so the clock only advances once the
device has finished the steps it counts. Device traces of training steps
(the JAX package's ``trace``) wait for the tooling slice.
"""

from __future__ import annotations

import time
from typing import Optional


class ThroughputMeter:
    """Sliding throughput: call update(batch_size) once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._images: list = []

    def update(self, batch_size: int) -> None:
        now = time.perf_counter()
        self._times.append(now)
        self._images.append(batch_size)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._images.pop(0)

    @property
    def images_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return sum(self._images[1:]) / dt if dt > 0 else None
