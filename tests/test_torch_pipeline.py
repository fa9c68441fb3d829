"""The single-chip sort-engine count job of fastkmer_tpu_torch vs
fastkmer_tpu, both on the CPU, on the same seeded FASTA: identical tables
from ``count_batches`` (adaptive / forced / no pre-dedup, forced spills,
``unique_ub``), byte-identical ``execute_job`` output directories, the
committed golden bytes, and a spill table handed from the JAX accumulator
to the port's.  Integer outputs, so the tolerance is bit-equality."""

import io
import json
import os
import zipfile

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fastkmer_tpu import api as japi  # noqa: E402
from fastkmer_tpu import pipeline as jpipe  # noqa: E402
from fastkmer_tpu.config import JobConfig  # noqa: E402
from fastkmer_tpu.ingest import batch as batching  # noqa: E402
from fastkmer_tpu.output import manifest as manifest_mod  # noqa: E402
from fastkmer_tpu_torch import api as tapi  # noqa: E402
from fastkmer_tpu_torch import pipeline as tpipe  # noqa: E402
from fastkmer_tpu_torch.ops import binhash as tbh  # noqa: E402

from .golden.make_golden import B as GB, K as GK, M as GM  # noqa: E402
from .test_pipeline_e2e import write_fasta  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def mixed_reads(seed: int, n: int = 90) -> list[str]:
    """A duplication-heavy stretch (reads from a 600 bp genome), then
    distinct reads with Ns, plus all-T reads and reads shorter than k + 16,
    so the adaptive controller engages pre-dedup and later disengages."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=600))
    reads = ["T" * 200, "A" * 33, "ACGTACGTACGTACGTACGTAC", "T" * 40]
    for _ in range(n):
        s = int(rng.integers(0, 300))
        reads.append(genome[s : s + int(rng.integers(160, 300))])
    for _ in range(n):
        chars = rng.choice(list("ACGT"), size=int(rng.integers(20, 400)))
        chars[rng.random(chars.size) < 0.02] = "N"
        reads.append("".join(chars))
    return reads


@pytest.fixture(scope="module")
def mixed_fa(tmp_path_factory):
    fa = str(tmp_path_factory.mktemp("torch_pipe") / "mixed.fa")
    write_fasta(fa, mixed_reads(5))
    return fa


def _assert_tables_equal(t, j, msg=""):
    np.testing.assert_array_equal(t.words, j.words, err_msg=msg)
    np.testing.assert_array_equal(t.counts, j.counts, err_msg=msg)
    np.testing.assert_array_equal(t.bins, j.bins, err_msg=msg)
    assert t.words.dtype == np.uint32 and t.counts.dtype == np.int64
    assert t.bins.dtype == np.int32
    assert (t.n_instances, t.n_bases, t.n_reads) == (j.n_instances, j.n_bases, j.n_reads)


@pytest.mark.parametrize("k,m", [(28, 10), (32, 9), (155, 13)])
@pytest.mark.parametrize("prededup", [None, True, False])
def test_count_batches_matches_jax(mixed_fa, k, m, prededup):
    B = 64

    def batches():
        return batching.batch_file(mixed_fa, 0, k, 4, 512)

    kw = dict(device_accumulate=True, prededup=prededup)
    if prededup is True and k % 16 == 0:
        # a forced prededup at k % 16 == 0 is an error in both packages
        with pytest.raises(NotImplementedError):
            jpipe.count_batches(batches(), k, m, B, **kw)
        with pytest.raises(NotImplementedError):
            tpipe.count_batches(batches(), k, m, B, device="cpu", **kw)
        return
    j = jpipe.count_batches(batches(), k, m, B, **kw)
    t = tpipe.count_batches(batches(), k, m, B, device="cpu", **kw)
    _assert_tables_equal(t, j, f"k={k} prededup={prededup}")
    assert len(t.counts) > 100
    assert t.n_batches == sum(1 for _ in batches())


@pytest.mark.parametrize("k,m", [(28, 10), (32, 9)])
def test_count_batches_host_path_and_unique_ub(mixed_fa, k, m):
    """device_accumulate=False (per-batch count + host merge) and the
    sync-free unique_ub feed both equal the JAX host path."""
    B = 64

    def batches():
        return batching.batch_file(mixed_fa, 0, k, 8, 512)

    j = jpipe.count_batches(batches(), k, m, B, device_accumulate=False)
    t = tpipe.count_batches(batches(), k, m, B, device="cpu", device_accumulate=False)
    _assert_tables_equal(t, j)
    ub = tpipe.count_batches(batches(), k, m, B, device="cpu", unique_ub=len(j.counts))
    _assert_tables_equal(ub, j)
    # a wrong bound raises at finalize, never loses counts silently
    acc = tpipe.DeviceAccumulator(k, fanin=2, m=m, B=B, acc_cap=16, unique_ub=16,
                                  device="cpu")
    assert acc.assume_fits
    for codes, _, _ in batches():
        acc.add_raw(tpipe._batch_extract_keys(torch.from_numpy(codes), k, m, B, k % 16 == 0))
    with pytest.raises(RuntimeError, match="overflow"):
        acc.finalize()


def test_small_acc_cap_spills_match_jax(mixed_fa):
    """A tiny acc_cap forces host spills mid-stream in both accumulators;
    the finalized tables are identical."""
    k, m, B = 28, 10, 64
    jacc = jpipe.DeviceAccumulator(k, fanin=2, m=m, B=B, acc_cap=1024)
    tacc = tpipe.DeviceAccumulator(k, fanin=2, m=m, B=B, acc_cap=1024, device="cpu")
    for codes, _, _ in batching.batch_file(mixed_fa, 0, k, 4, 512):
        jacc.add_raw(jpipe._batch_extract_keys(jnp.asarray(codes), k, m, B, False))
        tacc.add_raw(tpipe._batch_extract_keys(torch.from_numpy(codes), k, m, B))
    assert len(tacc.host_spills) >= 2 and jacc.host_spills
    for got, want in zip(tacc.finalize(), jacc.finalize()):
        np.testing.assert_array_equal(got, want)


def test_spill_handoff_from_jax_accumulator(mixed_fa):
    """host_spills produced by the JAX DeviceAccumulator on the CPU are
    finished by the port: one re-enters the port's device table through
    table_to_device, the rest merge as host spills.  The result equals
    JAX's own finalize."""
    k, m, B = 28, 10, 64
    jacc = jpipe.DeviceAccumulator(k, fanin=2, m=m, B=B, acc_cap=1024)
    for codes, _, _ in batching.batch_file(mixed_fa, 0, k, 4, 512):
        jacc.add_raw(jpipe._batch_extract_keys(jnp.asarray(codes), k, m, B, False))
    jacc._merge_pending()
    jacc._spill(jacc._stats())
    jacc.materialize_spills()
    spills = list(jacc.host_spills)
    assert len(spills) >= 2
    want = jacc.finalize()

    cols, counts, bins = tpipe.table_to_device(*spills[0], "cpu")
    for a, b in zip(tpipe.table_to_host(cols, counts, bins), spills[0]):
        np.testing.assert_array_equal(a, b)
    tacc = tpipe.DeviceAccumulator(k, fanin=2, m=m, B=B, device="cpu")
    tacc.add_part(cols, counts)
    tacc.host_spills.extend(spills[1:])
    for got, w in zip(tacc.finalize(), want):
        np.testing.assert_array_equal(got, w)


def _dir_bytes(d: str) -> dict[str, bytes]:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def _npz_members(data: bytes) -> dict[str, bytes]:
    """The .npy members of an npz (the zip headers carry a write time)."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("k,m", [(28, 10), (32, 9)])
def test_execute_job_output_dirs_identical(tmp_path, mixed_fa, k, m):
    """Text output (per-bin files + manifest) is byte-identical; binary
    output has identical counts.npz arrays and the same manifest apart
    from the npz file hash, which covers the zip's timestamps."""
    for kryo in (False, True):
        cfg = JobConfig(
            dataset=mixed_fa, output_directory=str(tmp_path) + "/", prefix="p_",
            k=k, m=m, max_b=64, write=True, use_kryo_serializer=kryo,
            use_custom_partitioner=True, num_partition_tasks=4,
            reads_per_batch=8, read_len=256,
        )
        jres = jpipe.execute_job(cfg, verbose=False)
        want = _dir_bytes(cfg.output_dir)
        tres = tpipe.execute_job(cfg, verbose=False, device="cpu")
        got = _dir_bytes(cfg.output_dir)
        _assert_tables_equal(tres, jres)
        assert sorted(got) == sorted(want)
        assert manifest_mod.verify_output(cfg.output_dir)["ok"]
        assert tapi.verify_output(cfg.output_dir) == manifest_mod.verify_output(cfg.output_dir)
        if not kryo:
            assert got == want
            continue
        assert _npz_members(got["counts.npz"]) == _npz_members(want["counts.npz"])
        jman, tman = json.loads(want["manifest.json"]), json.loads(got["manifest.json"])
        jman["extra_files"].pop("counts.npz")
        tman["extra_files"].pop("counts.npz")
        assert tman == jman


def test_execute_job_matches_golden_bytes(tmp_path):
    cfg = JobConfig(
        dataset=os.path.join(HERE, "golden", "golden.fa"),
        output_directory=str(tmp_path) + "/", prefix="gold_", k=GK, m=GM, x=3,
        max_b=GB, sequence_type=0, write=True, reads_per_batch=4, read_len=64,
    )
    tpipe.execute_job(cfg, verbose=False, device="cpu")
    got = {n: b for n, b in _dir_bytes(cfg.output_dir).items() if n.startswith("bin")}
    want = _dir_bytes(os.path.join(HERE, "golden", "expected"))
    assert got == want


def test_api_matches_jax(tmp_path, mixed_fa):
    j = japi.count_kmers(mixed_fa, k=25, m=8, bins=32)
    t = tapi.count_kmers(mixed_fa, k=25, m=8, bins=32, device="cpu")
    _assert_tables_equal(t, j)
    assert tapi.stats(t) == japi.stats(j)
    np.testing.assert_array_equal(tapi.spectrum(t, 50), japi.spectrum(j, 50))
    assert tapi.to_dict(t, 25) == japi.to_dict(j, 25)
    tapi.dump(t, 25, str(tmp_path / "t.txt"))
    japi.dump(j, 25, str(tmp_path / "j.txt"))
    assert open(tmp_path / "t.txt", "rb").read() == open(tmp_path / "j.txt", "rb").read()


@pytest.mark.parametrize("kw", [{"checkpoint_dir": "ck"}, {"trace_dir": "tr"},
                                {"keep_table": True}])
def test_unported_execute_job_options_raise(tmp_path, mixed_fa, kw):
    """The options ported since (checkpoint_dir, trace_dir, keep_table and
    useHT=1) run and leave their artifact: an emptied checkpoint directory,
    the trace, table.npz, and the same table under the HT engine."""
    kw = {a: str(tmp_path / v) if a.endswith("_dir") else v for a, v in kw.items()}
    cfg = JobConfig(dataset=mixed_fa, output_directory=str(tmp_path) + "/", k=25, m=8,
                    reads_per_batch=16, read_len=256)
    res = tpipe.execute_job(cfg, verbose=False, device="cpu", **kw)
    assert tapi.verify_output(cfg.output_dir)["ok"]
    if "checkpoint_dir" in kw:
        assert not os.listdir(kw["checkpoint_dir"])
    if "trace_dir" in kw:
        assert os.listdir(kw["trace_dir"])
    assert os.path.exists(os.path.join(cfg.output_dir, "table.npz")) == ("keep_table" in kw)
    cfg.use_ht = True
    ht = tpipe.execute_job(cfg, verbose=False, device="cpu")
    np.testing.assert_array_equal(ht.words, res.words)
    np.testing.assert_array_equal(ht.counts, res.counts)


def test_api_checkpoint_dir_reaches_the_job(tmp_path, mixed_fa):
    """``count_kmers`` takes ``checkpoint_dir`` as the JAX API does and hands
    it to the job: the run checkpoints there (every batch here) and empties
    the directory when it completes."""
    ck = tmp_path / "ck"
    res = tapi.count_kmers(mixed_fa, k=25, m=8, bins=32, checkpoint_dir=str(ck),
                           checkpoint_interval=1, device="cpu")
    assert ck.is_dir() and not os.listdir(ck)
    _assert_tables_equal(res, japi.count_kmers(mixed_fa, k=25, m=8, bins=32))


def test_part_weights_past_int32_spill_instead_of_wrapping():
    """Counted parts whose weights together pass 2^31 force a host spill
    (the device keeps int32 counts); the host merge sums in int64."""
    k, m, B = 28, 10, 64
    words = np.array([[0x12345678, 0x9ABCDE00], [0x0, 0x10]], np.uint32)
    big = 1_500_000_000
    acc = tpipe.DeviceAccumulator(k, m=m, B=B, acc_cap=1 << 14, device="cpu")
    for counts in ([big, 1], [big, 2]):
        cols, c, _ = tpipe.table_to_device(
            words, np.array(counts, np.int64), np.zeros(2, np.int32), "cpu"
        )
        acc.add_part(cols, c)
    assert len(acc.host_spills) == 1  # the second part could not join the first
    got_words, got_counts, got_bins = acc.finalize()
    np.testing.assert_array_equal(got_words, words[[1, 0]])
    np.testing.assert_array_equal(got_counts, [3, 2 * big])
    want_bins = tbh.bins_from_words(torch.from_numpy(words[[1, 0]].view(np.int32)), k, m, B)
    np.testing.assert_array_equal(got_bins, want_bins.numpy())
    cols, c, _ = tpipe.table_to_device(words[:1], np.array([1 << 31], np.int64),
                                       np.zeros(1, np.int32), "cpu")
    with pytest.raises(ValueError, match="WEIGHT_LIMIT"):
        acc.add_part(cols, c)


PK, PM, PB, PR, PL = 28, 10, 64, 64, 512


def _pin_batches(kind: str) -> list:
    """Fixed [R, L] code batches: 18 of distinct windows (each batch's
    distinct count passes the dedup step's npos/4 cap), or 10 built from
    four repeated rows (distinct ratio about 0.06) followed by 8 distinct."""
    rng = np.random.default_rng(23)
    out = []
    if kind == "dup":
        rows = rng.integers(0, 4, (4, PL), dtype=np.uint8)
        out += [rows[rng.integers(0, 4, PR)] for _ in range(10)]
    out += [rng.integers(0, 4, (PR, PL), dtype=np.uint8)
            for _ in range(8 if kind == "dup" else 18)]
    return [(c, PR, PR * PL) for c in out]


def _spy_merges(monkeypatch) -> list:
    """Record each accumulator merge as its parts' kinds: r raw, w weighted."""
    merges = []
    real = tpipe._acc_merge

    def spy(parts, acc, block_sort=False):
        merges.append("".join("r" if w is None else "w" for _, w in parts))
        return real(parts, acc, block_sort)

    monkeypatch.setattr(tpipe, "_acc_merge", spy)
    return merges


_DISTINCT_COUNTERS = {"raw_parts": 18, "spills": 9, "h2d_bytes": 589824, "d2h_bytes": 8939520}


@pytest.mark.parametrize("kind,prededup,counters,merges", [
    ("distinct", None, dict(_DISTINCT_COUNTERS, dedup_overflows=2), ["rr"] * 9),
    ("distinct", True, dict(_DISTINCT_COUNTERS, dedup_overflows=18), ["rr"] * 9),
    ("distinct", False, _DISTINCT_COUNTERS, ["rr"] * 9),
    ("dup", None,
     {"raw_parts": 10, "dedup_parts": 8, "dedup_overflows": 4, "spills": 4,
      "h2d_bytes": 589824, "d2h_bytes": 4004160},
     ["rr", "www", "www", "ww", "rr", "rr", "rr", "rr"]),
], ids=["distinct-adaptive", "distinct-forced", "distinct-off", "dup-adaptive"])
def test_count_batches_pre_dedup_feed_is_pinned(monkeypatch, kind, prededup, counters, merges):
    """The accumulator route of ``count_batches`` on fixed batches: the
    table equals the JAX package's on the same batches, and the counters,
    the span names and the sequence of merge windows are pinned.  On
    distinct batches every dedup step (the adaptive probes of batches 0
    and 16, or every batch when forced) overflows its cap and the batch
    goes in as raw columns; on the repeated rows the probe of batch 0
    engages dedup mode three batches later, and the distinct tail's
    overflows turn it off again."""
    got_merges = _spy_merges(monkeypatch)
    batches = _pin_batches(kind)
    res = tpipe.count_batches(batches, PK, PM, PB, device="cpu",
                              device_accumulate=True, prededup=prededup)
    want = jpipe.count_batches(batches, PK, PM, PB, device_accumulate=True, prededup=prededup)
    _assert_tables_equal(res, want, f"{kind} prededup={prededup}")
    assert res.counters == counters
    assert {s["name"] for s in res.spans} == {"ingest_wait", "device_count", "device_merge",
                                               "merge"}
    assert got_merges == merges


def test_accumulator_merge_windows_hold_one_kind(monkeypatch):
    """``add_part`` after ``add_raw`` merges the pending raw parts first,
    and ``add_raw`` after ``add_part`` the pending weighted ones."""
    merges = _spy_merges(monkeypatch)
    codes = [torch.from_numpy(c) for c, _, _ in _pin_batches("dup")[:4]]
    acc = tpipe.DeviceAccumulator(PK, fanin=16, m=PM, B=PB, unique_ub=1 << 16, device="cpu")
    acc.add_raw(tpipe._batch_extract_keys(codes[0], PK, PM, PB))
    acc.add_raw(tpipe._batch_extract_keys(codes[1], PK, PM, PB))
    assert merges == []
    cols, wts, _, over, _ = tpipe._batch_count_dedup(codes[2], PK, PM, PB,
                                                     tpipe._dedup_cap(PR * (PL - PK + 1)))
    assert int(over) == 0
    acc.add_part(cols, wts)
    assert merges == ["rr"]
    acc.add_raw(tpipe._batch_extract_keys(codes[3], PK, PM, PB))
    assert merges == ["rr", "w"]
    acc.check()
    assert merges == ["rr", "w", "r"]


def test_accumulator_check_merges_and_reads_the_counters():
    """``check`` merges the pending parts and returns ``n_unique`` and
    ``overflow``; a table too small for the asserted bound counts its
    losses in ``overflow``."""
    codes = [torch.from_numpy(c) for c, _, _ in _pin_batches("dup")[:2]]
    acc = tpipe.DeviceAccumulator(PK, fanin=16, m=PM, B=PB, device="cpu")
    small = tpipe.DeviceAccumulator(PK, m=PM, B=PB, acc_cap=16, unique_ub=16, device="cpu")
    for c in codes:
        acc.add_raw(tpipe._batch_extract_keys(c, PK, PM, PB))
        small.add_raw(tpipe._batch_extract_keys(c, PK, PM, PB))
    assert len(acc.pending) == 2
    stats = acc.check()
    assert acc.pending == [] and stats["overflow"] == 0
    assert stats["n_unique"] == len(acc.finalize()[1]) > 16
    stats = small.check()
    assert stats["n_unique"] == 16 and stats["overflow"] > 0
