"""Profiling and throughput telemetry.

Counterpart of ``tpuseg/utils/profiling.py``:

- :func:`span` marks a stretch of the program's own work (a tiled
  image's upload, a train step's backward) as a ``record_function``
  range, so that a profile of the card shows its kernels, copies and idle
  time under what the program was doing; :func:`spans` turns spans on for
  a region. Off, the default, a span costs one flag test;
- :func:`trace` records the enclosed steps with ``torch.profiler`` (host
  activity, and the card's kernels on a CUDA device) and writes a Chrome
  trace, ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``, which
  :mod:`tpuseg_torch.utils.trace_analysis` reads and Perfetto or
  ``chrome://tracing`` open. The caller marks each step with the
  profiler's ``step()``, so the trace holds one ``ProfilerStep#N`` span
  per step. Spans are on inside it;
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

_NULL = contextlib.nullcontext()
_SPANS = 0  # depth of the spans() regions open


def span(name: str, number: Optional[int] = None):
    """A context that marks the enclosed work as ``name`` in a profile, or
    as ``name#number`` for a span that encloses one request (a tiled
    image, a train step), as torch names ``ProfilerStep#N``: the Chrome
    export drops a range's arguments, so the number rides in the name.

    Outside :func:`spans`, the shared null context: nothing reaches
    ``torch.profiler``. Inside, ``torch.profiler.record_function``, an
    event on the host's clock in whatever profiler session records, beside
    the card's kernels and copies. Either way the span itself never waits
    for the card, reads it or allocates on it."""
    if not _SPANS:
        return _NULL
    import torch.profiler

    return torch.profiler.record_function(name if number is None else f"{name}#{number}")


@contextlib.contextmanager
def spans():
    """Turn :func:`span` on for the enclosed region, on every thread;
    regions nest."""
    global _SPANS
    _SPANS += 1
    try:
        yield
    finally:
        _SPANS -= 1


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
        with spans():
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
