"""Seconds per Gbp counted that the host waited for the card at the end of
its device spans: the ``sync_wait`` spans (the card's work that the host's
launches did not hide)."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("sync_wait",))
