"""Background prefetching of host batches.

The port's copy of the JAX package's data/prefetch.py: ref prefetch_queue.py:291 (enqueue_dicts_with_queue_
return + EnqueueHook software pipelining): a bounded background thread keeps
N batches ready so host data generation/parse overlaps the device step (the
device-side pipelining itself comes from CUDA's asynchronous launches)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(source: Iterable[T], size: int = 2) -> Iterator[T]:
    """Iterate `source` on a background thread with a buffer of `size`."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    err = []

    def worker():
        try:
            for item in source:
                q.put(item)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item
