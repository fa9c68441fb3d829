"""Structured per-stage timing — the port's copy of
``fastkmer_tpu.utils.timing``: ``StageTimer`` (its span totals) and
``maybe_profile`` on ``torch.profiler`` in place of ``jax.profiler``.

A span recorder that can be dumped as a dict/JSON, in place of the
reference's wall-clock prints (getDateDiff, package.scala:764-767).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

TRACE_FILE = "fastkmer_torch.pt.trace.json"


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


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace when trace_dir is given:
    host ops always, the card's kernels and copies when CUDA is available.
    The Chrome trace is written to ``<trace_dir>/TRACE_FILE`` when the
    region ends (its bytes are not part of the output contract)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
