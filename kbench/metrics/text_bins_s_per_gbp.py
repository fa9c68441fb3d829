"""Seconds of writing the text bin files per Gbp counted: the ``text_bins``
span (the writer's thread pool formatting, hashing and writing every bin
file, from its first bin to its last), a part of ``write_data``; None for
a binary job or a program without the span."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("text_bins",))
