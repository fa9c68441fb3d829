"""The readers of the program's finer spans (parse, packing, sync waits,
the writer's data) and of the idle time that no span accounts for, on a
hand-built run and trace; and None from a program without them."""

from __future__ import annotations

import pytest

from kbench import spec, trace
from kbench.harness import Run
from kbench.metrics import idle_unspanned_pct as m

SPANS = ("parse_s_per_gbp", "pack_s_per_gbp", "sync_wait_s_per_gbp", "write_data_s_per_gbp")


def test_span_readers():
    timings = {"ingest_parse": 0.5, "ingest_pack": 1.5, "ingest_wait": 1.0, "sync_wait": 0.25,
               "write_output": 4.0, "write_data": 3.0}
    run = Run(None, [{"timings": timings}] * 2, 10**9)
    got = {n: spec.metric_reader(n)(run) for n in SPANS}
    assert got == {"parse_s_per_gbp": 1.0, "pack_s_per_gbp": 3.0,
                   "sync_wait_s_per_gbp": 0.5, "write_data_s_per_gbp": 6.0}
    # the parent's jobs carry none of these spans
    old = Run(None, [{"timings": {"ingest_wait": 1.0, "write_output": 4.0}}], 10**9)
    assert all(spec.metric_reader(n)(old) is None for n in SPANS)


def _profile(host, device=((10, 30, "k"), (50, 60, "k")), job=(0.0, 100.0)):
    return trace.Profile(100e-6, job, list(device), list(host))


def _marks(name, b, e):
    return [(b, b + 1, f"fk:{name}:B"), (e, e + 1, f"fk:{name}:E")]


def test_idle_unspanned_share():
    """Idle holes [0, 10], [30, 50] and [60, 100] µs (70 µs).  write_output
    (28 to 53) covers the second hole whole, write_data inside it counts
    once, ingest_wait (70 to 81) covers 11 µs of the third; the root job
    covers everything and counts for nothing; an E without its B is left
    out.  Unspanned: 70 - 20 - 11 = 39 µs."""
    read = spec.metric_reader("idle_unspanned_pct")
    host = (_marks("job", 0, 99) + _marks("write_output", 28, 52) + _marks("write_data", 35, 44)
            + _marks("ingest_wait", 70, 80) + [(5, 6, "fk:merge:E"), (0, 100, "aten::empty")])
    p = _profile(host)
    assert m.idle_holes(p) == [[0.0, 10], [30, 50], [60, 100.0]]
    assert sorted(s[2] for s in m.intervals(p.host)) == [
        "ingest_wait", "job", "write_data", "write_output"]
    assert read(Run(None, [], 0, p)) == pytest.approx(100.0 * 39 / 70)
    # spans covering every hole leave nothing unspanned
    whole = _marks("job", 0, 99) + _marks("ingest_parse", 0, 12) + _marks("merge", 29, 99)
    assert read(Run(None, [], 0, _profile(whole))) == pytest.approx(0.0)


def test_idle_unspanned_none_without_markers():
    read = spec.metric_reader("idle_unspanned_pct")
    assert read(Run(None, [], 0, None)) is None
    assert read(Run(None, [], 0, _profile([(0, 100, "aten::empty")]))) is None
