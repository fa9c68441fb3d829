"""Seconds of the device count per Gbp counted: the ``device_count`` span
(kernel A and the dedup probe, with the batch's copy to the card) and the
``device_merge`` span (the accumulator's fan-in merges); each ends in a
synchronize."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("device_count", "device_merge"))
