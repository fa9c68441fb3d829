"""Span totals of the window's jobs, per Gbp counted.

The program's ``StageTimer`` keeps one total a span name a job; the CLI's
``--stats-json`` summary carries them under ``timings``.
"""

from __future__ import annotations


def per_gbp(run, names: tuple) -> float | None:
    """Seconds in the named spans over all the window's jobs, per Gbp the
    jobs counted; None when no job recorded any of them."""
    found = [j["timings"][n] for j in run.jobs for n in names if n in j["timings"]]
    if not found or not run.bases:
        return None
    return sum(found) / (run.bases / 1e9)
