"""Background batch prefetching — the port's copy of
``fastkmer_tpu.ingest.prefetch``.

Host-side parsing/encoding and device compute are serialized in a naive
loop; a one-thread prefetcher overlaps them (the role Spark's pipelined
task scheduler played for the reference).  Bounded queue => bounded host
memory; exceptions propagate to the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetched(batches: Iterable, depth: int = 2) -> Iterator:
    """Wrap a batch iterator so production runs in a background thread.

    NOTE: batches that share a reused buffer must be copied by the
    producer; ingest.batch.batch_file allocates a fresh buffer per yield,
    so it is safe here.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer() -> None:
        try:
            for b in batches:
                q.put(b)
        except BaseException as e:  # propagate parse errors to the consumer
            q.put(e)
            return
        q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
