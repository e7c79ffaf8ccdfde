"""Cancellable bounded queue for single-producer pipeline threads.

Both IO-overlap producers in the inference stack (the folder runner's
read-ahead thread and the whole-slide streaming window reader) share the
same failure mode: a bounded ``queue.Queue`` producer blocked in ``put``
outlives a consumer that stopped early (exception, generator close),
pinning the thread and its decoded images for process life. This helper is
that fix as one mechanism: the consumer's exit path calls :meth:`stop`,
and the producer's puts give up instead of blocking forever.

The port's own copy of ``tpuseg/utils/queues.py`` (the port imports
nothing of ``tpuseg``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any


class CancellableQueue:
    """A bounded queue plus a stop event.

    Producer side: :meth:`put` blocks like ``Queue.put`` but returns False
    (instead of blocking forever) once :meth:`stop` was called — the
    producer should then exit. :meth:`stopped` supports bailing out before
    expensive work. Consumer side: ``get()`` as usual; call :meth:`stop`
    in a ``finally`` so every exit path releases the producer.
    """

    def __init__(self, maxsize: int = 1):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()

    def put(self, item: Any, poll_s: float = 0.1) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=poll_s)
                return True
            except queue.Full:
                pass
        return False

    def get(self, *args, **kwargs) -> Any:
        return self._q.get(*args, **kwargs)

    def stop(self) -> None:
        self._stop.set()

    def stopped(self) -> bool:
        return self._stop.is_set()


def prefetch_iter(items, maxsize: int = 1, name: str = "tpuseg-prefetch"):
    """Iterate ``items`` on a daemon producer thread, ``maxsize`` ahead.

    One mechanism for both IO-overlap producers in the inference stack
    (folder read-ahead, whole-slide window streaming) instead of two
    hand-rolled copies of the thread/sentinel/stop pattern: the thread
    starts lazily on first iteration (so a consumer-setup failure before
    the loop never spawns it), exceptions raised while producing propagate
    to the consumer, and abandoning the generator (close / consumer
    exception / normal exhaustion) releases the producer via
    :class:`CancellableQueue` on every exit path.
    """
    q = CancellableQueue(maxsize=maxsize)
    _end = object()

    def produce():
        try:
            it = iter(items)
            while not q.stopped():
                try:
                    item = next(it)
                except StopIteration:
                    break
                if not q.put(item):
                    return
        except BaseException as e:  # propagate into the consumer
            q.put(e)
            return
        q.put(_end)

    threading.Thread(target=produce, daemon=True, name=name).start()
    try:
        while True:
            item = q.get()
            if item is _end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        q.stop()
