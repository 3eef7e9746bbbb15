"""Host-side batch prefetching (a copy of the JAX package's
`utils/prefetch.py`).

The training loop alternates host work (dataset indexing, image decode and
resize, collation, the copy to the device) with device steps. `prefetch_iter`
runs the batch producer on a background thread with a small bounded queue,
so batch N+1 assembles while step N runs on the device, the overlap the
reference gets from the DataLoader's `num_workers`.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch_iter(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `it` on a background thread, `depth` items ahead.

    Exceptions in the producer re-raise at the consumer's next pull; the
    producer thread is a daemon, so abandoning the iterator cannot hang
    interpreter shutdown."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def run():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:          # re-raised on the consumer side
            q.put(("__error__", e))
            return
        q.put(_SENTINEL)

    t = threading.Thread(target=run, daemon=True, name="lvr-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, tuple) and len(item) == 2 \
                and item[0] == "__error__":
            raise item[1]
        yield item


def map_prefetch(fn: Callable[..., T], args_iter: Iterable,
                 depth: int = 2) -> Iterator[T]:
    """`prefetch_iter(map(fn, args_iter))`."""
    return prefetch_iter((fn(a) for a in args_iter), depth=depth)
