"""Background input prefetching (port of
heterofusionrcnn_tpu/datasets/prefetch.py, with one worker thread).

Wraps any `next_batch` callable with a worker thread and a bounded queue, so
that host-side loading (PNG decode, resize, point sampling, labels) and the
copy to the device overlap the device's steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable


class BatchPrefetcher:
    """Bounded-queue prefetcher: `next()` returns batches in order."""

    def __init__(
        self,
        next_batch: Callable[[], dict],
        capacity: int = 4,
        transform: Callable = None,
    ):
        # One worker thread: the KittiDataset epoch state is not thread-safe.
        # `transform` runs in the worker thread on each produced batch: the
        # trainer passes the copy to the device here, so that it overlaps
        # the previous step.
        if transform is not None:
            base = next_batch
            next_batch = lambda: transform(base())  # noqa: E731
        self._next_batch = next_batch
        self._queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._error = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._next_batch()
            except Exception as e:  # propagate to the consumer
                self._error = e
                self._queue.put(None)
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        item = self._queue.get()
        if item is None and self._error is not None:
            raise self._error
        return item

    __call__ = next

    def close(self):
        self._stop.set()
        # Drain so workers blocked on put() can exit.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
