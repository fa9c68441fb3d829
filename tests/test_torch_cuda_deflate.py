"""The card's deflate of counts.npz (``output.cuda_deflate``) through its
plain version, on the CPU: every stream inflates back to its input (zlib,
raw), segment cuts included; the CRC combine is zlib's; the codes are
complete prefix codes within their limits; an npz assembled from the plain
encoder's members (``npz._Zip``, the card path's container) loads
through ``np.load``, ``zipfile`` and both packages' ``api.load_binary``; and
on a read set's table it is within 3% of ``np.savez_compressed``'s size.
The kernel itself is held to the plain version byte for byte on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import os
import zipfile
import zlib

import numpy as np
import pytest

from fastkmer_tpu import api as japi
from fastkmer_tpu_torch import api as tapi
from fastkmer_tpu_torch.output import cuda_deflate as cd
from fastkmer_tpu_torch.output import npz

from .test_torch_npz_writer import _members, _table

SEG = cd.SEG


def _inputs() -> dict[str, bytes]:
    rng = np.random.default_rng(23)
    tail = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    return {
        "empty": b"",
        "one_byte": b"\x07",
        "under_a_segment": b"the k-mer counts of a read set " * 300,
        "segments_and_an_odd_tail": np.where(
            rng.random(3 * SEG // 8 + 777) < 0.78, 1,
            rng.integers(2, 200, 3 * SEG // 8 + 777)).astype(np.int64).tobytes()[:3 * SEG + 4321],
        "random": rng.integers(0, 256, SEG + 999, dtype=np.uint8).tobytes(),
        "zeros": bytes(2 * SEG + 3),
        # the second segment opens with the first one's last 5000 bytes
        "match_across_a_cut": rng.integers(0, 256, SEG - 5000, dtype=np.uint8).tobytes()
        + tail + tail + b"!",
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", list(INPUTS))
def test_plain_stream_inflates_to_its_input(name):
    data = INPUTS[name]
    z, crc, segs, stored = cd.deflate_plain(data)
    o = zlib.decompressobj(-15)
    assert o.decompress(z) == data
    assert o.eof and not o.unused_data
    assert crc == zlib.crc32(data)
    assert segs == max(1, -(-len(data) // SEG))
    if name == "random":
        assert stored == segs  # incompressible: every segment goes stored
    if name == "zeros":  # two segments of long matches, then 3 bytes stored
        assert stored == 1 and len(z) < 1000


def test_a_match_reaches_back_across_a_segment_cut():
    """The segment after a cut takes its first match from the window before
    it, so the repeat costs a few bytes, not 5000."""
    data = INPUTS["match_across_a_cut"]
    buf = bytes(data)
    prev = cd.prev_links(np.frombuffer(buf, np.uint8)).tolist()
    tokens = cd.parse(buf, prev, SEG, len(buf))
    assert tokens[0][0] == SEG and tokens[0][1] > 0 and tokens[0][0] - tokens[0][2] < SEG
    assert len(cd.deflate_plain(data)[0]) < SEG - 5000 + 5000 + 200


@pytest.mark.parametrize("sizes", [(0, 5), (1, 65536), (65536, 65536), (3, 0), (70001, 12)])
def test_crc32_combine_is_zlibs(sizes):
    rng = np.random.default_rng(sum(sizes))
    a, b = (rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes)
    assert cd.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(a + b)


@pytest.mark.parametrize("freqs,limit", [
    ([5, 0], 15), ([0, 0, 0], 15), ([0, 9, 0, 0], 15), ([3, 3, 3, 3, 3], 7),
    ([1 << i for i in range(25)], 15),  # a tree 24 deep, cut to 15
    ([int(x) for x in np.random.default_rng(1).integers(0, 1000, 286)], 15),
    ([2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0, 7], 7),
])
def test_huffman_lengths_are_complete_prefix_codes(freqs, limit):
    lengths = cd.huffman_lengths(freqs, limit)
    used = [b for b in lengths if b]
    assert max(used) <= limit and len(used) >= 2
    assert sum(2.0 ** -b for b in used) == 1.0  # complete: every code word is used
    assert all(lengths[i] for i, f in enumerate(freqs) if f)
    codes = cd.canonical_codes(lengths)
    words = {format(c, f"0{b}b")[::-1] for c, b in zip(codes, lengths) if b}
    assert len(words) == len(used)
    assert not any(x != y and y.startswith(x) for x in words for y in words)


def _plain_npz(path: str, arrays: dict) -> list:
    """The card path's container (``npz._Zip``) around the plain version's
    members."""
    coded = []
    with open(path, "wb") as f:
        z = npz._Zip(f)
        for name, a in arrays.items():
            head, data = npz._member(a)
            z.start(f"{name}.npy".encode(), len(head) + len(data))
            coded.append(cd.deflate_plain(bytes(head) + bytes(data)))
            z.write(coded[-1][0])
        z.close([c[1] for c in coded])
    return coded


@pytest.mark.parametrize("n", [0, 3000])
def test_an_npz_of_plain_members_loads_everywhere(tmp_path, n):
    words, counts, bins = _table(55, n)
    path = str(tmp_path / "counts.npz")
    _plain_npz(path, {"words": words, "counts": counts, "bins": bins, "k": np.int32(55)})
    ref = str(tmp_path / "ref.npz")
    np.savez_compressed(ref, words=words, counts=counts, bins=bins, k=np.int32(55))
    assert _members(path) == _members(ref)
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        assert [i.filename for i in z.infolist()] == ["words.npy", "counts.npy", "bins.npy",
                                                      "k.npy"]
        assert all(i.compress_type == zipfile.ZIP_DEFLATED for i in z.infolist())
    with np.load(path, allow_pickle=False) as z:
        np.testing.assert_array_equal(z["words"], words)
        np.testing.assert_array_equal(z["counts"], counts)
        assert int(z["k"]) == 55
    for api in (japi, tapi):
        res = api.load_binary(path)
        for got, want in ((res.words, words), (res.counts, counts), (res.bins, bins)):
            np.testing.assert_array_equal(np.asarray(got), want)


def test_plain_npz_is_within_3pct_of_savez_compressed(tmp_path):
    """A read set's table (random sorted k-mers, most counts 1): the card's
    stream within 3% of zlib level 6's (0.3% over it when written)."""
    words, counts, bins = _table(55, 12_000)
    path, ref = str(tmp_path / "card.npz"), str(tmp_path / "ref.npz")
    coded = _plain_npz(path, {"words": words, "counts": counts, "bins": bins,
                              "k": np.int32(55)})
    np.savez_compressed(ref, words=words, counts=counts, bins=bins, k=np.int32(55))
    assert os.path.getsize(path) <= 1.03 * os.path.getsize(ref)
    assert [c[2] for c in coded] == [3, 2, 1, 1]
    assert coded[0][3] == 2  # two of the random words' three segments go stored


@pytest.mark.parametrize("piece", [1, 2, 3, 1024])
def test_plan_covers_every_segment_once_with_its_window(piece):
    """The launches' segments are the members' segments in order; each
    member's copy starts ``WIN`` before its first segment there (or at its
    start), 64-byte aligned; the chain kernel's blocks tile each copy."""
    sizes = [128 + 12_000 * 16, 5, 3 * SEG, 2 * SEG + 1]
    pieces = cd.plan(sizes, piece)
    got = []
    for pc in pieces:
        assert pc.segs.shape[1] <= piece
        copy = {m: (lo, hi, at) for m, lo, hi, at in pc.copies}
        for s, e, last, m in pc.segs.T.tolist():
            lo, hi, at = copy[m]
            got.append((m, s - at + lo, e - at + lo))
            assert last == (e - at + lo == sizes[m]) and at % 64 == 0 and s % 16 == 0
        for m, (lo, hi, at) in copy.items():
            first = min(s for s, _, _, mm in pc.segs.T.tolist() if mm == m) - at + lo
            assert lo == max(0, first - cd.WIN)
            blocks = [(a, b) for a, b, c, d in pc.ranges.T.tolist() if (c, d) == (at, at + hi - lo)]
            assert blocks[0][0] == at and blocks[-1][1] == at + hi - lo
            assert all(b0 == a1 for (_, b0), (a1, _) in zip(blocks, blocks[1:]))
        assert pc.nbuf >= max(at + hi - lo for lo, hi, at in copy.values())
    want = [(m, k * SEG, min(n, (k + 1) * SEG)) for m, n in enumerate(sizes)
            for k in range(-(-n // SEG))]
    assert got == want
