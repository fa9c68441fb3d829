"""The port's own copies of the host layer vs the JAX package's modules:
``config.JobConfig`` (fields, defaults, derived values, ``describe``),
``ingest.batch.batch_file`` on FASTA, FASTQ and gzip input through the
native and the python parsers, multiseq's tagged packing
(``batch_codes_dense_tagged``, one sequence a row), the LPT and hash owner maps and the
exchange cap, ``output.writer`` + ``manifest`` bytes (with the HT
engine's and a repair's writer options), ``verify_output``, the table
sidecar and checkpoint files, the native k-way merge, and the multi-host
helpers (``parallel.multihost``'s striping, the manifest shards and their
merge, ``clean_output_dir`` and ``write_binary``).  Exact equality throughout."""

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
from fastkmer_tpu.parallel import multihost as jmh  # noqa: E402
from fastkmer_tpu.parallel import partitioner as jpart  # noqa: E402
from fastkmer_tpu_torch import config as tconfig  # noqa: E402
from fastkmer_tpu_torch.core import bits as tbits  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as tbatch  # noqa: E402
from fastkmer_tpu_torch.output import manifest as tman  # noqa: E402
from fastkmer_tpu_torch.output import writer as twriter  # noqa: E402
from fastkmer_tpu_torch.output import native as tnative  # noqa: E402
from fastkmer_tpu_torch.parallel import multihost as tmh  # noqa: E402
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


@pytest.mark.parametrize("p", [1, 2, 3, 5])
def test_batch_striping_is_the_jax_one(monkeypatch, p):
    """``stripe_batches``, ``stripe_batches_padded`` (lockstep padding
    with all-invalid batches) and ``host_stripe`` for every rank of p,
    uneven tails included; JAX's ``host_stripe`` reads the process count,
    so it is set to p here."""
    for n_batches in (0, 1, p - 1, 2 * p + 1, 7):
        batches = [(np.full((2, 5), i, np.uint8), i, 10 * i) for i in range(n_batches)]
        for i in range(p):
            got = list(tmh.stripe_batches(iter(batches), p, i))
            assert got == list(jmh.stripe_batches(iter(batches), p, i))
            got = list(tmh.stripe_batches_padded(iter(batches), 2, 5, p, i))
            want = list(jmh.stripe_batches_padded(iter(batches), 2, 5, p, i))
            assert len(got) == len(want) == -(-n_batches // p)
            for (gc, gr, gb), (wc, wr, wb) in zip(got, want):
                np.testing.assert_array_equal(gc, wc)
                assert (gr, gb, gc.dtype) == (wr, wb, wc.dtype)
    for n_items in (0, 1, 7, 26, 100):
        monkeypatch.setattr(jmh.jax, "process_count", lambda: p)
        for i in range(p):
            monkeypatch.setattr(jmh.jax, "process_index", lambda i=i: i)
            assert tmh.host_stripe(n_items, p, i) == jmh.host_stripe(n_items)
    assert tmh.host_stripe(10) == (0, 10)  # one process


@pytest.mark.parametrize("binary", [False, True])
def test_manifest_shards_are_the_jax_ones(tmp_path, binary):
    """``write_manifest_shard`` for three ranks' disjoint bin sets and
    ``merge_manifest_shards``: the same bytes as the JAX package's, and a
    merged manifest that ``verify_output`` passes; shards that claim the
    same bin are refused by both."""
    words, counts, bins = _table(5, 28, 300)
    cfg = {"k": 28, "output_directory": "out/"}
    rank = bins % 3
    for d, writer, man in (("j", jwriter, jman), ("t", twriter, tman)):
        out = str(tmp_path / d)
        for r in range(3):
            sel = rank == r
            hashes = extra = None
            if binary:
                name = f"counts.part{r}.npz"
                path = writer.write_binary(out, words[sel], counts[sel], bins[sel], 28,
                                           name=name, clean=False)
                extra = {name: "%064d" % r}  # the npz bytes hold zip timestamps
                assert os.path.basename(path) == name
            else:
                hashes = writer.write_bin_files(out, words[sel], counts[sel], bins[sel], 28,
                                                clean=False)
            man.write_manifest_shard(out, cfg, words[sel], counts[sel], bins[sel], r,
                                     bin_hashes=hashes, extra_files=extra, binary=binary)
        man.merge_manifest_shards(out, 3)
    got, want = _dir_bytes(str(tmp_path / "t")), _dir_bytes(str(tmp_path / "j"))
    names = [n for n in want if n.endswith(".json")]
    assert sorted(names) == ["manifest.json"] + [f"manifest.part{r}.json" for r in range(3)]
    for n in names:
        assert got[n] == want[n], n
    if not binary:
        assert got == want and tman.verify_output(str(tmp_path / "t"))["ok"]
    bad = str(tmp_path / "bad")
    for r in range(2):
        tman.write_manifest_shard(bad, cfg, words, counts, bins, r)
    for man in (tman, jman):
        with pytest.raises(RuntimeError, match="same bins"):
            man.merge_manifest_shards(bad, 2)


def test_clean_output_dir_and_write_binary_are_the_jax_ones(tmp_path):
    """``clean_output_dir`` removes bins, npz outputs and manifest shards
    and keeps everything else; ``write_binary`` writes the same members
    under its name, and cleans stale outputs only with ``clean``."""
    words, counts, bins = _table(9, 28, 100)
    keep = ["manifest.json", "table.npz", "notes.txt", "binary", "counts.part0.npz.tmp"]
    stale = ["bin3", "bin12", "counts.npz", "counts.part1.npz", "manifest.part0.json"]
    for d, writer in (("j", jwriter), ("t", twriter)):
        out = tmp_path / d
        out.mkdir()
        for n in keep + stale:
            (out / n).write_bytes(b"x")
        writer.clean_output_dir(str(out))
        assert sorted(os.listdir(out)) == sorted(keep)
        writer.clean_output_dir(str(tmp_path / d / "new"))  # makes the directory
        assert os.listdir(tmp_path / d / "new") == []
        (out / "bin3").write_bytes(b"x")
        writer.write_binary(str(out), words, counts, bins, 28, name="counts.part2.npz",
                            clean=False)
        assert (out / "bin3").exists()
        writer.write_binary(str(out), words, counts, bins, 28)
        assert not (out / "bin3").exists() and not (out / "counts.part2.npz").exists()
    with np.load(tmp_path / "j" / "counts.npz") as j, np.load(tmp_path / "t" / "counts.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for f in j.files:
            np.testing.assert_array_equal(t[f], j[f])
