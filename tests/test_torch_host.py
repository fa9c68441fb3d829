"""The port's own copies of the host layer vs the JAX package's modules:
``config.JobConfig`` (fields, defaults, derived values, ``describe``),
``ingest.batch.batch_file`` on FASTA, FASTQ and gzip input through the
native and the python parsers, multiseq's tagged packing
(``batch_codes_dense_tagged``, one sequence a row), the LPT and hash owner maps and the
exchange cap, ``output.writer`` + ``manifest`` bytes (with the HT
engine's and a repair's writer options), ``verify_output``, the table
sidecar and checkpoint files, and the native k-way merge.  Exact equality throughout."""

import dataclasses
import gzip
import json
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


@pytest.mark.parametrize("R,L", [(4, 64), (3, 150)])
def test_tagged_packer_is_the_jax_one(R, L):
    """Tagged dense packing: the JAX batches (codes, per-row sids, read and
    base counts), from strings and from encoded reads; every row holds
    reads of one sequence, and the reads decode back out in order."""
    rng = np.random.default_rng(3 + L)
    tagged = []
    for _ in range(57):
        ln = int(rng.integers(5, 40)) if L == 64 else int(rng.integers(20, 150))
        tagged.append((int(rng.integers(0, 4)), "".join(rng.choice(list("ACGTN"), size=ln))))
    for encoded in (False, True):
        reads = [(t, tbits.encode_ascii(r) if encoded else r) for t, r in tagged]
        want = list(jbatch.batch_codes_dense_tagged(iter(reads), R, L))
        got = list(tbatch.batch_codes_dense_tagged(iter(reads), R, L))
        assert len(got) == len(want) > 1
        for (gc, gs, gr, gb), (wc, ws, wr, wb) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gs, ws)
            assert gs.dtype == ws.dtype == np.int32 and (gr, gb) == (wr, wb)
    seen = []
    for codes, sids, _, _ in got:
        assert codes.shape == (R, L)
        for r in range(R):
            # reads are separated by one invalid cell; Ns inside a read are
            # invalid too, so compare the reads' segments between them
            segs = [s for s in bytes(np.where(codes[r] < 4, codes[r], 9)).split(b"\t") if s]
            seen += [(int(sids[r]), "".join("ACGT"[c] for c in seg)) for seg in segs]
    want_segs = [(t, seg) for t, r in tagged for seg in r.split("N") if seg]
    assert seen == want_segs
    with pytest.raises(ValueError, match="read_len"):
        list(tbatch.batch_codes_dense_tagged(iter([(0, "A" * (L + 1))]), R, L))


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


@pytest.mark.parametrize("k", [28, 55])
def test_writer_options_are_the_jax_ones(tmp_path, k):
    """``eof_sentinel=False`` (the HT engine's bins), ``clean=False`` (a
    repair's partial rewrite, which keeps the other bins) and
    ``write_binary_with_manifest(extra_files=...)``: the same bytes as the
    JAX writer."""
    words, counts, bins = _table(k + 1, k, 300)
    half = bins < 8
    for d, writer in (("j", jwriter), ("t", twriter)):
        out = str(tmp_path / d)
        assert writer.write_bin_files(out, words, counts, bins, k, eof_sentinel=False)
        writer.write_bin_files(out, words[half], counts[half] + 1, bins[half], k,
                               eof_sentinel=False, clean=False)
    got, want = _dir_bytes(str(tmp_path / "t")), _dir_bytes(str(tmp_path / "j"))
    assert got == want and not any(b.endswith(b"EOF") for b in got.values())
    assert len(got) == len(np.unique(bins))  # clean=False kept the other bins
    extra = {"distances.json": "ab" * 32}
    for d, writer in (("jk", jwriter), ("tk", twriter)):
        writer.write_binary_with_manifest(str(tmp_path / d), {"k": k}, words, counts, bins, k,
                                          extra_files=extra)
    jm, tm = (_dir_bytes(str(tmp_path / d))["manifest.json"] for d in ("jk", "tk"))
    jm, tm = json.loads(jm), json.loads(tm)
    assert tm["extra_files"].pop("distances.json") == jm["extra_files"].pop("distances.json")
    # the npz hashes differ by the zip members' timestamps only
    assert sorted(tm["extra_files"]) == sorted(jm["extra_files"]) == ["counts.npz"]
    tm["extra_files"] = jm["extra_files"] = None
    assert tm == jm


def test_table_sidecar_and_checkpoint_files_are_the_jax_ones(tmp_path):
    """table.npz and a checkpoint directory written by either package load
    in the other; a sidecar that disagrees with the manifest is refused by
    both."""
    words, counts, bins = _table(3, 28, 200)
    for d, writer_man, other in (("j", jman, tman), ("t", tman, jman)):
        out = str(tmp_path / d)
        writer_man.write_manifest(out, {"k": 28}, words, counts, bins)
        writer_man.write_table_sidecar(out, words, counts, bins)
        for g, w in zip(other.load_table_sidecar(out), (words, counts, bins)):
            np.testing.assert_array_equal(g, w)
        writer_man.write_table_sidecar(out, words, counts + 1, bins)
        assert other.load_table_sidecar(out) is None and writer_man.load_table_sidecar(out) is None
        ck = str(tmp_path / f"ck_{d}")
        c = writer_man.BatchCheckpointer(ck, interval=2)
        c.save_spills(2, [(words, counts, bins)], 0)
        c.save_spills(4, [(words[:5], counts[:5], bins[:5])] * 2, 1)
        r = other.BatchCheckpointer(ck)
        assert r.completed_batches() == 4 and r._cursor() == c._cursor()
        assert [p[0].shape[0] for p in r.load_parts()] == [200, 5, 5]
        pb = str(tmp_path / f"pb_{d}")
        writer_man.BatchCheckpointer(pb).save_batch(0, words, counts, bins)
        writer_man.BatchCheckpointer(pb).save_batch(1, words[:3], counts[:3], bins[:3])
        r = other.BatchCheckpointer(pb)
        assert r.completed_batches() == 2
        for g, w in zip(r.load_parts()[1], (words[:3], counts[:3], bins[:3])):
            np.testing.assert_array_equal(g, w)
    assert (open(tmp_path / "ck_j" / "cursor.json").read()
            == open(tmp_path / "ck_t" / "cursor.json").read())
