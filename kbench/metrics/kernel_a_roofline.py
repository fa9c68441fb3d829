"""Kernel A's share of its roofline in the traced job: the least time its
launches need at the card's bandwidth (kbench.roofline, from each launch's
[R, L] batch and k) over the time its rows took on the card.  Every batch
the job sends is [reads_per_batch, read_len] (the last one padded), so
each launch moves the same bytes."""

from __future__ import annotations

import re

from kbench import roofline

ROW = re.compile(r"\bextract_count(_bytes)?_kernel\b")


def read(run) -> float | None:
    if run.profile is None:
        return None
    us = [b - a for a, b, name in run.profile.device if ROW.search(name)]
    if not us:
        return None
    j = run.job
    bytes_in, bytes_out = roofline.extract_count_bytes(j.reads_per_batch, j.read_len, j.k)
    least = len(us) * roofline.least_seconds(bytes_in + bytes_out)
    return 100.0 * least / (sum(us) / 1e6)
