"""Seconds a job waited on host ingest (parse, encode, the prefetch queue) per
Gbp counted: the ``ingest_wait`` span of the window's jobs."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("ingest_wait",))
