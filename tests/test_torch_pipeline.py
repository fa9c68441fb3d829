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
    cfg = JobConfig(dataset=mixed_fa, output_directory=str(tmp_path) + "/", k=25, m=8)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tpipe.execute_job(cfg, verbose=False, device="cpu", **kw)
    cfg.use_ht = True
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tpipe.execute_job(cfg, verbose=False, device="cpu")


def test_api_checkpoint_dir_reaches_the_job(tmp_path, mixed_fa):
    """``count_kmers`` takes ``checkpoint_dir`` as the JAX API does and hands
    it to the job, which says resume is not ported (not a ``JobConfig``
    TypeError)."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tapi.count_kmers(mixed_fa, k=25, m=8, bins=32, checkpoint_dir=str(tmp_path / "ck"),
                         device="cpu")


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
