"""The port's own copies of the host layer vs the JAX package's modules:
``config.JobConfig`` (fields, defaults, derived values, ``describe``),
``ingest.batch.batch_file`` on FASTA, FASTQ and gzip input through the
native and the python parsers, the LPT and hash owner maps and the
exchange cap, ``output.writer`` + ``manifest`` bytes, ``verify_output``
and the native k-way merge.  Exact equality throughout."""

import dataclasses
import gzip
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from fastkmer_tpu import config as jconfig  # noqa: E402
from fastkmer_tpu.core import bits as jbits  # noqa: E402
from fastkmer_tpu.ingest import batch as jbatch  # noqa: E402
from fastkmer_tpu.output import manifest as jman  # noqa: E402
from fastkmer_tpu.output import writer as jwriter  # noqa: E402
from fastkmer_tpu.output import native as jnative  # noqa: E402
from fastkmer_tpu.parallel import partitioner as jpart  # noqa: E402
from fastkmer_tpu_torch import config as tconfig  # noqa: E402
from fastkmer_tpu_torch.core import bits as tbits  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as tbatch  # noqa: E402
from fastkmer_tpu_torch.output import manifest as tman  # noqa: E402
from fastkmer_tpu_torch.output import writer as twriter  # noqa: E402
from fastkmer_tpu_torch.output import native as tnative  # noqa: E402
from fastkmer_tpu_torch.parallel import partitioner as tpart  # noqa: E402

from .test_torch_cli import _dir_bytes  # noqa: E402
from .test_torch_pipeline import mixed_reads  # noqa: E402


def test_job_config_is_the_jax_one():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.JobConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.JobConfig)]
    assert tf == jf
    for kw in ({}, {"use_custom_partitioner": True, "num_partition_tasks": 4, "prefix": "p_"},
               {"debug": True, "m": 4, "max_b": 9}, {"k": 31, "read_len": 8}):
        args = dict(dataset="in.fa", output_directory="out/", **kw)
        j, t = jconfig.JobConfig(**args), tconfig.JobConfig(**args)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.b, t.output_dir, t.describe()) == (j.b, j.output_dir, j.describe())
    with pytest.raises(ValueError):
        tconfig.JobConfig(dataset="a", output_directory="", k=10, m=10)


def _write_inputs(tmp_path) -> dict[str, str]:
    reads = mixed_reads(3, n=40) + ["ACGT" * 300]  # a read past read_len: chunked
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n" + "\n".join(r[j:j + 60] for j in range(0, len(r), 60)) + "\n")
    fq = str(tmp_path / "in.fq")
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    gz = str(tmp_path / "in.fa.gz")
    with open(fa, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    return {"fasta": fa, "fastq": fq, "gzip": gz}


@pytest.mark.parametrize("seq_type", [0, 1])
def test_batch_file_is_the_jax_one(tmp_path, seq_type):
    for path in _write_inputs(tmp_path).values():
        for native in (None, False):
            args = (path, seq_type, 28, 8, 256)
            want = list(jbatch.batch_file(*args, use_native=native))
            got = list(tbatch.batch_file(*args, use_native=native))
            assert len(got) == len(want) > 1
            for (gc, gr, gb), (wc, wr, wb) in zip(got, want):
                np.testing.assert_array_equal(gc, wc)
                assert (gr, gb) == (wr, wb)


def test_partitioner_is_the_jax_one():
    rng = np.random.default_rng(5)
    for B, n, T in ((64, 8, 8), (2048, 4, 4), (100, 3, 16)):
        hist = rng.integers(0, 1000, size=B) * (rng.random(B) < 0.8)
        np.testing.assert_array_equal(tpart.lpt_owner_map(hist, T, B),
                                      jpart.lpt_owner_map(hist, T, B))
        np.testing.assert_array_equal(tpart.hash_owner_map(B, n), jpart.hash_owner_map(B, n))
        own = tpart.lpt_owner_map(hist, T, B) % n
        assert tpart.balance_stats(hist, own, n) == jpart.balance_stats(hist, own, n)
        for pos in (1000, 4_000_000):
            assert (tpart.size_exchange_cap(hist, own, n, pos)
                    == jpart.size_exchange_cap(hist, own, n, pos))


def _table(seed: int, k: int, n: int):
    rng = np.random.default_rng(seed)
    W = jbits.num_words(k)
    words = np.unique(rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint32), axis=0)
    if k % 16:
        words[:, -1] &= np.uint32((0xFFFFFFFF << (32 - 2 * (k % 16))) & 0xFFFFFFFF)
        words = np.unique(words, axis=0)
    counts = rng.integers(1, 1000, size=words.shape[0]).astype(np.int64)
    bins = rng.integers(0, 17, size=words.shape[0]).astype(np.int32)
    return words, counts, bins


@pytest.mark.parametrize("k", [13, 28, 32, 55])
def test_writer_and_manifest_are_the_jax_ones(tmp_path, k):
    words, counts, bins = _table(k, k, 300)
    cfg = {"k": k, "note": "x"}
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jman.write_manifest(jd, cfg, words, counts, bins,
                        bin_hashes=jwriter.write_bin_files(jd, words, counts, bins, k))
    tman.write_manifest(td, cfg, words, counts, bins,
                        bin_hashes=twriter.write_bin_files(td, words, counts, bins, k))
    assert _dir_bytes(td) == _dir_bytes(jd)
    assert tman.verify_output(td) == jman.verify_output(td)
    assert tman.verify_output(td)["ok"]
    kryo = str(tmp_path / "kryo")
    twriter.write_binary_with_manifest(kryo, cfg, words, counts, bins, k)
    assert tman.verify_output(kryo) == jman.verify_output(kryo) and tman.verify_output(kryo)["ok"]
    np.testing.assert_array_equal(np.load(os.path.join(kryo, "counts.npz"))["words"], words)
    # a changed byte and a missing bin are caught the same way
    name = sorted(n for n in os.listdir(td) if n.startswith("bin"))[0]
    with open(os.path.join(td, name), "r+b") as f:
        f.write(b"G" if f.read(1) != b"G" else b"C")
    os.remove(os.path.join(td, sorted(n for n in os.listdir(td) if n.startswith("bin"))[-1]))
    res = tman.verify_output(td)
    assert res == jman.verify_output(td) and not res["ok"] and res["missing"] and res["mismatched"]
    assert tbits.decode_words_batch(words, k) == jbits.decode_words_batch(words, k)


def test_native_merge_is_the_jax_one():
    parts = [_table(s, 28, 200) for s in range(4)]
    parts[1] = (parts[0][0][::2], parts[0][1][::2], parts[0][2][::2])  # shared keys
    want = jnative.merge_sorted_parts(parts, 2)
    got = tnative.merge_sorted_parts(parts, 2)
    assert want is not None and got is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
