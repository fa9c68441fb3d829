"""Share of the traced job's wall time in which nothing ran on the card:
100 minus the union of its kernel, copy and fill rows over the wall."""

from __future__ import annotations

from kbench import trace


def read(run) -> float | None:
    if run.profile is None or not run.profile.device:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(run.profile) / run.profile.wall_s)
