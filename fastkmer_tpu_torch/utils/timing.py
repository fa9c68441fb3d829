"""Structured per-stage timing — the port's copy of
``fastkmer_tpu.utils.timing``: ``StageTimer`` (span totals, each span's
record and counters), ``fenced_span`` (a span that waits for its CUDA
devices) and ``maybe_profile`` on ``torch.profiler`` in place of
``jax.profiler``.

A span recorder that can be dumped as a dict/JSON, in place of the
reference's wall-clock prints (getDateDiff, package.scala:764-767).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict

import torch
from torch.profiler import record_function

TRACE_FILE = "fastkmer_torch.pt.trace.json"
MARKER = "fk:{}:{}"  # a span's markers: fk:<name>:B at its start, fk:<name>:E at its end


def _profiling() -> bool:
    """Whether a torch profiler records this thread's operators."""
    return torch.autograd._profiler_enabled()


def _marker(name: str) -> None:
    with record_function(name):
        pass


class StageTimer:
    """The port's span and counter recorder; safe to share between threads.

    ``span(name)`` adds its seconds to the name's total (``as_dict``) and
    keeps a record of it (``records``): its id, name, start and end in
    seconds from the recorder's creation (``time.perf_counter``), the id of
    its parent (the innermost span open on the same thread, or the
    ``parent`` given) and the name of its thread.  ``count(name, n)`` adds
    ``n`` to a counter (``counters``).

    While a torch profiler is active, a span opened on the thread that
    created the recorder also enters two empty ``record_function`` ranges,
    ``fk:<name>:B`` before its start and ``fk:<name>:E`` after its end:
    their CPU rows give the span's interval on the profiler's clock, and
    since no work runs inside them no device row is attributed to them.
    The profiler records only the thread that started it, so spans of
    other threads enter none.
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self._counters: dict[str, float] = defaultdict(int)
        self._records: list[tuple] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._open = threading.local()  # .stack: ids of this thread's open spans
        self._t0 = time.perf_counter()
        self._owner = threading.get_ident()

    def current(self) -> int | None:
        """The id of the innermost span open on the calling thread."""
        stack = getattr(self._open, "stack", None)
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def span(self, name: str, parent: int | None = None):
        stack = self._open.__dict__.setdefault("stack", [])
        sid = next(self._ids)
        if parent is None and stack:
            parent = stack[-1]
        mark = threading.get_ident() == self._owner and _profiling()
        if mark:
            _marker(MARKER.format(name, "B"))
        stack.append(sid)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            stack.pop()
            if mark:
                _marker(MARKER.format(name, "E"))
            thread = threading.current_thread().name
            with self._lock:
                self.totals[name] += t1 - t0
                self._records.append((sid, name, t0 - self._t0, t1 - self._t0, parent, thread))

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def as_dict(self) -> dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def records(self) -> list[dict]:
        """The closed spans in the order they opened."""
        with self._lock:
            rows = sorted(self._records)
        return [dict(id=sid, name=name, start=start, end=end, parent=parent, thread=thread)
                for sid, name, start, end, parent, thread in rows]


@contextlib.contextmanager
def fenced_span(timer: StageTimer, name: str, *devs: torch.device):
    """Timer span that waits for its CUDA devices at its end, so each span
    holds its own device work rather than the work queued before it; the
    wait is its child span ``sync_wait``, and each synchronize counts in
    ``syncs``."""
    with timer.span(name):
        yield
        cuda = [dev for dev in dict.fromkeys(devs) if dev.type == "cuda"]
        if cuda:
            with timer.span("sync_wait"):
                for dev in cuda:
                    torch.cuda.synchronize(dev)
            timer.count("syncs", len(cuda))


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace when trace_dir is given:
    host ops always, the card's kernels and copies when CUDA is available.
    The Chrome trace is written to ``<trace_dir>/TRACE_FILE`` when the
    region ends (its bytes are not part of the output contract)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
