"""Seconds of the parse per Gbp counted: the ``ingest_parse`` span (the
native parser reads and encodes the whole FASTA file in the job's thread,
before the first batch) of the window's jobs."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("ingest_parse",))
