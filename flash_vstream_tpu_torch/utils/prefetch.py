"""Background host-side batch prefetch.

Port of flash_vstream_tpu/utils/prefetch.py: training batches are assembled
on the host (frame decode, resize, patchify, tokenize) on one thread while
the card runs the previous step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class BackgroundPrefetcher:
    """Runs `make(i)` for i in [start, stop) on a background thread, keeping
    up to `depth` results ready. Exceptions re-raise on the consumer side."""

    _SENTINEL = object()

    def __init__(self, make: Callable[[int], object], start: int, stop: int,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once close() is called, so a
            # consumer that stops early never leaves this thread blocked
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for i in range(start, stop):
                    if self._stop.is_set() or not put(make(i)):
                        return
            except BaseException as e:     # noqa: BLE001 (re-raised below)
                self._err = e
            finally:
                put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self):
        """Stop the producer and join it; safe mid-iteration."""
        self._stop.set()
        self._thread.join(timeout=5)
