"""The binary output's block-parallel npz writer (``output.npz`` through
``output.writer.write_binary``) against ``np.savez_compressed``: the same
members byte for byte, read back by ``np.load``, ``zipfile`` and both
packages' ``api.load_binary`` with every CRC holding, the same file bytes
on one core and on eight, a size within 0.5% of numpy's, blocks primed
with the window before them, and the ``write_blocks`` / ``write_threads``
counters."""

import os
import zipfile

import numpy as np
import pytest

from fastkmer_tpu import api as japi
from fastkmer_tpu_torch import api as tapi
from fastkmer_tpu_torch.output import npz, writer
from fastkmer_tpu_torch.utils import timing

# rows: an empty table, one under a block, and many blocks with an odd tail
SIZES = {"empty": 0, "one_block": 1_000, "many_blocks": 400_001}


def _table(k: int, n: int):
    """A sorted table shaped like a read set's: random k-mers, most counts 1."""
    rng = np.random.default_rng(k * 1_000_003 + n)
    words = rng.integers(0, 1 << 32, size=(n, -(-2 * k // 32)), dtype=np.uint32)
    words = words[np.lexsort(words.T[::-1])]
    counts = np.where(rng.random(n) < 0.78, 1, rng.integers(2, 200, n)).astype(np.int64)
    bins = rng.integers(0, 2048, n).astype(np.int32)
    return words, counts, bins


def _members(path) -> dict[str, bytes]:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _cores(monkeypatch, n: int) -> None:
    monkeypatch.setattr(npz.os, "sched_getaffinity", lambda pid: set(range(n)))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("k", [28, 55])
def test_npz_is_savez_compressed(tmp_path, monkeypatch, k, size):
    """Each member is numpy's byte for byte, in numpy's order and DEFLATED;
    ``np.load`` reads the table back exactly and every CRC holds.  The
    job's writer hands its timer down to the counters."""
    _cores(monkeypatch, 8)
    words, counts, bins = _table(k, SIZES[size])
    t = timing.StageTimer()
    path = writer.write_binary_with_manifest(str(tmp_path / "out"), {"k": k}, words, counts,
                                             bins, k, timer=t)
    ref = str(tmp_path / "ref.npz")
    np.savez_compressed(ref, words=words, counts=counts, bins=bins, k=np.int32(k))
    got, want = _members(path), _members(ref)
    assert list(got) == list(want) == ["words.npy", "counts.npy", "bins.npy", "k.npy"]
    for name in want:
        assert got[name] == want[name], name
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        assert all(i.compress_type == zipfile.ZIP_DEFLATED for i in z.infolist())
        assert all(i.date_time == (1980, 1, 1, 0, 0, 0) for i in z.infolist())
    with np.load(path, allow_pickle=False) as z:
        for name, arr in (("words", words), ("counts", counts), ("bins", bins),
                          ("k", np.int32(k))):
            assert z[name].dtype == arr.dtype and z[name].shape == arr.shape, name
            np.testing.assert_array_equal(z[name], arr)
    for api in (japi, tapi):  # the JAX package's reader and the port's
        res = api.load_binary(path)
        for got_arr, arr in ((res.words, words), (res.counts, counts), (res.bins, bins)):
            np.testing.assert_array_equal(np.asarray(got_arr), arr)
    blocks = sum(max(1, -(-a.nbytes // npz.BLOCK)) for a in (words, counts, bins)) + 1
    pooled = sum(-(-a.nbytes // npz.BLOCK) for a in (words, counts, bins)
                 if a.nbytes > npz.BLOCK)
    assert t.counters()["write_blocks"] == blocks
    assert t.counters()["write_threads"] == (min(8, pooled) if pooled else 1)
    if size == "many_blocks":
        assert t.counters()["write_threads"] > 1
    assert {"write_data", "write_sha256", "write_manifest"} <= set(t.as_dict())


@pytest.mark.parametrize("k", [28, 55])
def test_npz_bytes_do_not_depend_on_the_cores(tmp_path, monkeypatch, k):
    """One worker (every block on the calling thread) and eight write the
    same file; its size is within 0.5% of ``np.savez_compressed``'s."""
    words, counts, bins = _table(k, SIZES["many_blocks"])
    files, threads = [], []
    for cores in (1, 8):
        _cores(monkeypatch, cores)
        t = timing.StageTimer()
        files.append(open(writer.write_binary(str(tmp_path / str(cores)), words, counts,
                                              bins, k, timer=t), "rb").read())
        threads.append(t.counters()["write_threads"])
    assert threads == [1, 8]
    assert files[0] == files[1]
    ref = str(tmp_path / "ref.npz")
    np.savez_compressed(ref, words=words, counts=counts, bins=bins, k=np.int32(k))
    assert abs(len(files[0]) / os.path.getsize(ref) - 1) < 0.005


def test_npz_blocks_are_primed_with_the_window_before_them(tmp_path, monkeypatch):
    """Words that repeat every 16 KiB over four blocks: each block after a
    member's first finds its matches in the 32 KiB before it, so the words
    member deflates within 1% of numpy's one stream (0.4% over it here;
    unprimed blocks double it)."""
    _cores(monkeypatch, 8)
    pattern = np.random.default_rng(3).integers(0, 1 << 32, size=(1024, 4), dtype=np.uint32)
    words = np.tile(pattern, (256, 1))
    counts, bins = np.ones(len(words), np.int64), np.zeros(len(words), np.int32)
    path = writer.write_binary(str(tmp_path / "out"), words, counts, bins, 55)
    ref = str(tmp_path / "ref.npz")
    np.savez_compressed(ref, words=words, counts=counts, bins=bins, k=np.int32(55))
    assert _members(path) == _members(ref)
    with zipfile.ZipFile(path) as got, zipfile.ZipFile(ref) as want:
        sizes = [z.getinfo("words.npy").compress_size for z in (got, want)]
    assert abs(sizes[0] / sizes[1] - 1) < 0.01
