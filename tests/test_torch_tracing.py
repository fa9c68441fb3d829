"""The port's span and counter recorder (``utils.timing.StageTimer``) and
the spans and counters of a count job: records nest by parent and thread,
the totals are their spans' seconds, two threads lose no update, the
``fk:`` markers appear only under a profiler, one pair a main-thread span
with nothing inside, ``native_pack_batches`` counts the natively filled
batches, and ``--stats-json`` carries spans and counters."""

import json
import os
import sys
import threading
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fastkmer_tpu_torch import cli as tcli  # noqa: E402
from fastkmer_tpu_torch import pipeline as tpipe  # noqa: E402
from fastkmer_tpu_torch.config import JobConfig  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as tbatch  # noqa: E402
from fastkmer_tpu_torch.ingest import native as tnative  # noqa: E402
from fastkmer_tpu_torch.ingest.prefetch import prefetched  # noqa: E402
from fastkmer_tpu_torch.utils import timing  # noqa: E402

K, M, R, L = 28, 8, 16, 256


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """300 reads of 100 bases from a 4,000-base genome (k-mers repeat)."""
    rng = np.random.default_rng(17)
    genome = rng.choice(list(b"ACGT"), 4000).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("tracing") / "in.fa")
    with open(path, "wb") as f:
        for i, p in enumerate(rng.integers(0, genome.size - 100, 300)):
            f.write(b">r%d\n" % i + genome[p:p + 100].tobytes() + b"\n")
    return path


def _cfg(fa, out, binary=False) -> JobConfig:
    return JobConfig(dataset=fa, output_directory=out, k=K, m=M, x=3, max_b=64,
                     sequence_type=0, write=True, use_kryo_serializer=binary,
                     reads_per_batch=R, read_len=L)


def _batch_bytes(fa) -> int:
    return sum(codes.nbytes for codes, _, _ in tbatch.batch_file(fa, 0, K, R, L))


def _by_name(records) -> dict:
    out = defaultdict(list)
    for r in records:
        out[r["name"]].append(r)
    return out


def test_records_nest_by_parent_and_thread():
    t = timing.StageTimer()
    me = threading.current_thread().name
    with t.span("job"):
        with t.span("a"):
            with t.span("b"):
                assert t.current() is not None
        assert list(prefetched(iter([1, 2, 3]), timer=t)) == [1, 2, 3]
    assert t.current() is None
    by = _by_name(t.records())
    (job,), (a,), (b,) = by["job"], by["a"], by["b"]
    assert job["parent"] is None and a["parent"] == job["id"] and b["parent"] == a["id"]
    assert job["thread"] == a["thread"] == b["thread"] == me
    assert job["start"] <= a["start"] <= b["start"] <= b["end"] <= a["end"] <= job["end"]
    # one a batch and one that finds the end, on the producer thread, whose
    # parent is the span open where the prefetch was made
    packs = by["ingest_pack"]
    assert len(packs) == 4
    assert all(p["parent"] == job["id"] and p["thread"] == "fk-prefetch" for p in packs)
    assert all(job["start"] <= p["start"] <= p["end"] <= job["end"] for p in packs)
    for name, rows in by.items():
        assert t.as_dict()[name] == pytest.approx(sum(r["end"] - r["start"] for r in rows))


def test_threads_lose_no_total():
    """More threads than cores and a short switch interval: every span and
    count of every thread is kept."""
    t = timing.StageTimer()
    n_threads = (os.cpu_count() or 1) + 1
    n = max(200, 60_000 // n_threads)

    def work():
        for _ in range(n):
            with t.span("s"):
                t.count("c")
            t.count("bytes", 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    records = t.records()
    assert len(records) == n * n_threads == len({r["id"] for r in records})
    assert t.counters() == {"c": n * n_threads, "bytes": 3 * n * n_threads}
    assert t.as_dict()["s"] == pytest.approx(sum(r["end"] - r["start"] for r in records))


def test_span_waits_for_the_card_in_sync_wait(monkeypatch):
    """A device span's synchronizes run in its child ``sync_wait``, one
    count each in ``syncs``; a CPU span has neither."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    t = timing.StageTimer()
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    with timing.fenced_span(t, "device_count", c0, cpu, c1, c0):
        pass
    with timing.fenced_span(t, "host", cpu):
        pass
    assert synced == [c0, c1] and t.counters() == {"syncs": 2}
    by = _by_name(t.records())
    assert by["sync_wait"][0]["parent"] == by["device_count"][0]["id"]
    assert set(by) == {"device_count", "sync_wait", "host"}


@pytest.mark.parametrize("path,binary,kw", [
    ("host", False, {}),
    ("accumulator", True, {"unique_ub": 1 << 16}),
    ("dedup", False, {"prededup": True}),
])
def test_job_spans_totals_and_counters(tmp_path, fasta, path, binary, kw):
    """A job's root ``job`` holds every other main-thread span; each total
    is its spans' seconds; the parse, the packing and the writer's parts
    have their parents; the counters count the job's batches and bytes."""
    res = tpipe.execute_job(_cfg(fasta, str(tmp_path) + "/", binary), verbose=False,
                            device="cpu", **kw)
    by = _by_name(res.spans)
    (job,) = by["job"]
    me = threading.current_thread().name
    assert {"ingest_parse", "ingest_pack", "ingest_wait", "device_count", "merge",
            "write_output", "write_data", "write_manifest"} <= set(by)
    assert ("host_compact" in by) == (path == "host")
    assert ("write_sha256" in by) == binary
    for r in res.spans:
        if r is not job:
            assert job["start"] <= r["start"] <= r["end"] <= job["end"]
            assert r["thread"] == ("fk-prefetch" if r["name"] == "ingest_pack" else me)
    ids = {r["id"]: r for r in res.spans}
    for r in res.spans:
        want = "write_output" if r["name"].startswith("write_") and r["name"] != \
            "write_output" else "job"
        assert r is job or ids[r["parent"]]["name"] == want, r
    assert set(res.timings) == set(by)
    for name, rows in by.items():
        assert res.timings[name] == pytest.approx(sum(r["end"] - r["start"] for r in rows))
    c = res.counters
    assert c["h2d_bytes"] == _batch_bytes(fasta) and c["d2h_bytes"] > 0
    assert "syncs" not in c  # nothing to wait for on the CPU
    if path == "host":
        assert not {"raw_parts", "dedup_parts", "spills"} & set(c)
    else:
        assert c.get("raw_parts", 0) + c.get("dedup_parts", 0) == res.n_batches
        assert c["spills"] == 1 and "dedup_overflows" not in c
        # adaptive: the probe of batch 0 is the one dedup part (the job has
        # fewer than 16 batches, and its reads are too distinct to engage)
        assert c["dedup_parts"] == (res.n_batches if path == "dedup" else 1)
    text_counters = {"write_format_s", "write_hash_s", "write_file_s"}
    assert (text_counters <= set(c)) == (not binary)


@pytest.mark.parametrize("native", [True, False])
def test_native_pack_batches_counts_the_native_route(tmp_path, fasta, monkeypatch, native):
    """``native_pack_batches`` counts the batches the native route fills,
    one a batch; the python fallback (no native library) leaves it out, so
    a job that fell back shows it."""
    if not native:
        monkeypatch.setattr(tnative, "available", lambda: False)
    res = tpipe.execute_job(_cfg(fasta, str(tmp_path) + "/"), verbose=False, device="cpu")
    assert res.n_batches == len(list(tbatch.batch_file(fasta, 0, K, R, L))) > 1
    assert res.counters.get("native_pack_batches") == (res.n_batches if native else None)
    t = timing.StageTimer()
    assert len(list(tbatch.batch_file(fasta, 0, K, R, L, use_native=native, timer=t))) \
        == res.n_batches
    assert t.counters().get("native_pack_batches") == (res.n_batches if native else None)


def test_markers_only_under_a_profiler(tmp_path, fasta, monkeypatch):
    """No profiler: no ``record_function`` is entered.  Under one: two a
    main-thread span and none from the ingest thread."""
    calls = []
    real = timing.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(timing, "record_function", counting)
    cfg = _cfg(fasta, str(tmp_path) + "/")
    tpipe.execute_job(cfg, verbose=False, device="cpu")
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        res = tpipe.execute_job(cfg, verbose=False, device="cpu")
    main = [r for r in res.spans if r["thread"] != "fk-prefetch"]
    assert len(calls) == 2 * len(main)
    assert sorted(calls) == sorted(f"fk:{r['name']}:{e}" for r in main for e in "BE")


def test_markers_pair_in_order_with_nothing_inside(tmp_path, fasta):
    """Under a CPU profiler each main-thread span leaves one ``fk:<name>:B``
    and one ``fk:<name>:E`` row, nested as the spans are, in the order the
    spans opened, and no other row starts inside a marker."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = tpipe.execute_job(_cfg(fasta, str(tmp_path) + "/", binary=True),
                                verbose=False, device="cpu")
    rows = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CPU)
    markers = [r for r in rows if r[2].startswith("fk:")]
    stack, opened = [], []
    for _, _, name in markers:
        _, span, edge = name.split(":")
        if edge == "B":
            stack.append(span)
            opened.append(span)
        else:
            assert stack.pop() == span
    assert not stack
    main = [r["name"] for r in res.spans if r["thread"] != "fk-prefetch"]
    assert opened == main and main[0] == "job"
    for a, b, name in markers:
        assert not [r for r in rows if a <= r[0] < b and r != (a, b, name)], name


def test_stats_json_carries_spans_and_counters(tmp_path, fasta):
    stats = str(tmp_path / "stats.json")
    argv = [str(K), str(M), "3", "64", "0", "0", fasta, str(tmp_path) + "/", "t_", "1", "0",
            "0", "--reads-per-batch", str(R), "--read-len", str(L), "--device", "cpu",
            "--stats-json", stats]
    assert tcli.main(argv) == 0
    with open(stats) as f:
        s = json.load(f)
    assert s["counters"]["h2d_bytes"] == _batch_bytes(fasta)
    names = {r["name"] for r in s["spans"]}
    assert names == set(s["timings"]) and "job" in names
    assert all(set(r) == {"id", "name", "start", "end", "parent", "thread"}
               for r in s["spans"])
