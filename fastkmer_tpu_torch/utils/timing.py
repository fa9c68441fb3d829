"""Structured per-stage timing — the port's copy of
``fastkmer_tpu.utils.timing.StageTimer`` (its span totals).

A span recorder that can be dumped as a dict/JSON, in place of the
reference's wall-clock prints (getDateDiff, package.scala:764-767).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def as_dict(self) -> dict[str, float]:
        return dict(self.totals)
