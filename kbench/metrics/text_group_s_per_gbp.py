"""Seconds of grouping the text output's rows by bin per Gbp counted: the
``text_group`` span (the stable sort of the table by bin, the gathers and
the bins' bounds, on the main thread), a part of ``write_data``; None for a
binary job or a program without the span."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("text_group",))
