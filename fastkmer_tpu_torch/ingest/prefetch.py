"""Background batch prefetching — the port's copy of
``fastkmer_tpu.ingest.prefetch``.

Host-side parsing/encoding and device compute are serialized in a naive
loop; a one-thread prefetcher overlaps them (the role Spark's pipelined
task scheduler played for the reference).  Bounded queue => bounded host
memory; exceptions propagate to the consumer.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetched(batches: Iterable, depth: int = 2, timer=None) -> Iterator:
    """Wrap a batch iterator so production runs in a background thread.

    A ``timer`` (utils.timing.StageTimer) gets one span ``ingest_pack`` a
    batch from the producer thread, around taking the next batch from
    ``batches``; their parent is the span open where this is called.

    NOTE: batches that share a reused buffer must be copied by the
    producer; ingest.batch.batch_file allocates a fresh buffer per yield,
    so it is safe here.
    """
    parent = timer.current() if timer else None
    return _prefetch(iter(batches), depth, timer, parent)


def _prefetch(it: Iterator, depth: int, timer, parent: int | None) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer() -> None:
        try:
            while True:
                with (timer.span("ingest_pack", parent) if timer
                      else contextlib.nullcontext()):
                    b = next(it, _SENTINEL)
                if b is _SENTINEL:
                    break
                q.put(b)
        except BaseException as e:  # propagate parse errors to the consumer
            q.put(e)
            return
        q.put(_SENTINEL)

    t = threading.Thread(target=producer, name="fk-prefetch", daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
