"""Async input pipeline: background-thread batch prefetch.

Replaces the reference's DataLoader(num_workers=12) process pool
(train_model.py:83-84) with a bounded producer thread: host-side collation
overlaps device compute, which is all that is needed since features are
precomputed in RAM.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from ..utils.profiling import span

_SENTINEL = object()


def prefetch(iterable: Iterable, size: int = 2) -> Iterator:
    """Yield items from `iterable`, produced ahead of time on a thread.

    The producer's puts time out against a stop flag, so an abandoned
    generator (consumer raised out of its for-loop, or was GC'd early)
    releases the thread and the queued batches instead of leaving a
    daemon thread blocked on a full queue holding device-sharded arrays
    alive for the process lifetime.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    err = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            with span("akx.feed_wait"):
                item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]
    finally:
        stop.set()
