"""Seconds of the finalize per Gbp counted: the ``merge`` span (the
accumulator's last merge and spill, ``bins_from_words``, the host
``merge_partials``) and ``host_compact``."""

from __future__ import annotations

from kbench.spans import per_gbp


def read(run) -> float | None:
    return per_gbp(run, ("merge", "host_compact"))
