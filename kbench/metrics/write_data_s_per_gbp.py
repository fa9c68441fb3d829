"""Seconds of writing the output's data per Gbp counted: the
``write_data`` span (``counts.npz``: zlib and the file; or the text bin
files), a part of ``write_output``."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("write_data",))
