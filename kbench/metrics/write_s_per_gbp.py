"""Seconds of the writer per Gbp counted: the ``write_output`` span (text bin
files or counts.npz, and the manifest)."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("write_output",))
