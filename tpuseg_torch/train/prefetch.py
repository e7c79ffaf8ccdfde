"""Host->device input pipeline: asynchronous double-buffered prefetch.

Counterpart of ``tpuseg/train/prefetch.py`` (the reference's
``tf.data .prefetch()`` stage, train.py:85-90). A background thread pulls
numpy batches from the readers, pins them, and copies them to the card
with ``non_blocking`` copies on a side CUDA stream, ``depth`` batches
ahead, so the copy of batch N+1 overlaps the compute of batch N.

Two rules keep an early read or a reused buffer from corrupting a batch:

- the consumer's stream waits for the copy of the batch it takes: each
  batch carries a CUDA event recorded on the copy stream after its copies
  (a finer ``wait_stream``: it does not also wait for copies of batches
  queued behind it);
- every tensor of the batch is ``record_stream``ed on the consumer's
  stream, so the caching allocator does not hand its memory to a later
  copy before the consumer's kernels that read it have run. The pinned
  host buffers are guarded by the same allocator, which holds each one
  until its copy has finished.

uint16 data (the raw images) is copied as int16, the same bytes, and
widened to int32 on the card, because torch's uint16 support is partial.
On a CPU device the batches are wrapped without copies.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, Tuple

import numpy as np
import torch


def _as_tensor(arr: np.ndarray) -> Tuple[torch.Tensor, bool]:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)), True
    return torch.from_numpy(arr), False


def _widen(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).bitwise_and_(0xFFFF)


def device_prefetch(host_iter: Iterator[Tuple[np.ndarray, ...]], device,
                    depth: int = 2) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield each host batch (a tuple of numpy arrays) as tensors on
    ``device``, ``depth`` batches ahead."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_last(item) -> None:
        # Terminal put (sentinel / exception) that cannot deadlock when the
        # consumer has already left: once `stop` is set the consumer never
        # get()s again, so a Full queue means nobody needs the item.
        while True:
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                if stop.is_set():
                    return

    def to_device(arr: np.ndarray) -> torch.Tensor:
        t, is_u16 = _as_tensor(arr)
        if cuda:
            t = t.pin_memory().to(device, non_blocking=True)
        return _widen(t) if is_u16 else t

    def producer():
        it = iter(host_iter)
        ctx = (torch.cuda.stream(copy_stream) if cuda else contextlib.nullcontext())
        try:
            with ctx:
                while not stop.is_set():
                    # stop is checked BEFORE the pull: closing the iterator
                    # must not consume (and discard) one more batch from the
                    # shared reader queue — the trainer closes the test
                    # iterator every test epoch to stop that consumption
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    tensors = tuple(to_device(a) for a in batch)
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                    q.put((tensors, ready))
        except Exception as e:  # surface reader crashes to the consumer
            put_last(e)
        finally:
            put_last(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            tensors, ready = item
            if cuda:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for x in tensors:
                    x.record_stream(consumer)
            yield tensors
    finally:
        stop.set()
        # drain so the producer can exit its q.put
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
