"""Share of the card's idle time in the traced job that no span of the
program accounts for.

The program marks each span of its main thread in the profiler's timeline
with two empty ranges, ``fk:<name>:B`` at its start and ``fk:<name>:E`` at
its end.  Paired by name, innermost first, they give the spans' intervals
on the trace's clock.  The idle time is the holes in the union of the
device rows between the traced job's ends; its unspanned part is where no
span but the root ``job`` is open (the CLI's own start and end, the
harness's ``os.sync``, host work no span covers).  None when the trace
holds no marker."""

from __future__ import annotations

import re

from kbench import trace

MARK = re.compile(r"^fk:(.+):([BE])$")
ROOT = "job"


def intervals(host) -> list:
    """(start, end, name) of every paired marker of the host rows: the
    start of the B row to the end of its E row."""
    open_, out = {}, []
    for a, b, name in sorted(host):
        m = MARK.match(name)
        if not m:
            continue
        span, edge = m.groups()
        if edge == "B":
            open_.setdefault(span, []).append(a)
        elif open_.get(span):
            out.append((open_[span].pop(), b, span))
    return out


def idle_holes(p) -> list:
    """[start, end] of each hole in the device's busy union inside the job."""
    start, end = p.job
    holes, t = [], start
    for a, b in trace.merged(p.device):
        if a > t:
            holes.append([t, min(a, end)])
        t = max(t, b)
    if end > t:
        holes.append([t, end])
    return [h for h in holes if h[1] > h[0]]


def covered(holes, spans) -> float:
    """Microseconds of the holes that the spans' union covers."""
    total = 0.0
    for a, b in trace.merged(spans):
        for h0, h1 in holes:
            total += max(0.0, min(b, h1) - max(a, h0))
    return total


def read(run) -> float | None:
    p = run.profile
    if p is None or p.job is None:
        return None
    spans = intervals(p.host)
    if not spans:
        return None
    holes = idle_holes(p)
    idle = sum(b - a for a, b in holes)
    if not idle:
        return None
    inner = [s for s in spans if s[2] != ROOT]
    return 100.0 * (idle - covered(holes, inner)) / idle
