"""Profiling and throughput telemetry.

Counterpart of ``tpuseg/utils/profiling.py``:

- :func:`trace` records the enclosed steps with ``torch.profiler`` (host
  activity, and the card's kernels on a CUDA device) and writes a Chrome
  trace, ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``, which
  :mod:`tpuseg_torch.utils.trace_analysis` reads and Perfetto or
  ``chrome://tracing`` open. The caller marks each step with the
  profiler's ``step()``, so the trace holds one ``ProfilerStep#N`` span
  per step;
- :class:`ThroughputMeter`: the trainer calls :meth:`ThroughputMeter.update`
  right after reading the window's loss back from the card, so the clock
  only advances once the device has finished the steps it counts.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: str, device="cpu"):
    """Profile the enclosed region and yield the profiler; call its
    ``step()`` between steps. The trace is written when the region ends,
    also when it ends by an exception."""
    import torch
    from torch.profiler import ProfilerAction, ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    # a schedule (one that always records) makes step() mark ProfilerStep#N
    prof = profile(activities=activities, schedule=lambda step: ProfilerAction.RECORD)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(logdir, name))


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
