"""Seconds of batch packing per Gbp counted: the ``ingest_pack`` spans of
the prefetch thread (one a batch).  They overlap ``ingest_wait`` and the
device spans of the job's thread: what they exceed ``ingest_wait`` by is
the ingest work the prefetch hides."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("ingest_pack",))
