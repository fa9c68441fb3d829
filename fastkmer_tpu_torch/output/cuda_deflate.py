"""counts.npz's members deflated on the card: the hand-written kernel's
wrapper (``csrc/deflate.cu``) and its plain version.

It replaces no TPU kernel: the JAX package writes counts.npz with
``np.savez_compressed``, one zlib thread on the host.  On the card the
deflate takes milliseconds where the host's cores take most of a job
(the source's note says what bounds it).  ``npz.write_npz`` takes this
path for a CUDA device and keeps the host's block-parallel zlib for the
CPU.

**The stream.**  A member's bytes (its ``.npy`` header, then the array's)
are cut into segments of ``SEG`` input bytes.  Each segment is one deflate
block that may take matches from the ``WIN`` bytes before it, so the
segments laid end to end are one raw deflate stream; ``SEG`` is a
constant, and the stream's bytes depend on the member alone.  A segment is
coded as follows, and the plain version here repeats every rule:

1. Hash chains.  A position's hash is ``((b0 << 10) ^ (b1 << 5) ^ b2) &
   0x7FFF`` over its three bytes; ``prev[p]`` is the distance to the
   latest earlier position of the same hash, if that is at most ``WIN``
   back, else 0 (``prev_links``).
2. The match at p (``find``): the chain from p is walked for at most
   ``CHAIN`` candidates, stopping at a candidate more than ``WIN`` back;
   a candidate's length is the common prefix of the bytes at it and at p,
   at most ``MAX_MATCH`` and never past the segment's end.  The longest
   wins, the nearest of equals; the walk stops early at the longest length
   the segment allows.  Under 3 bytes, or 3 bytes more than ``TOO_FAR``
   back, is no match.
3. The parse, lazy by one position: at p with a match of length l, the
   match is taken unless l < ``LAZY``, p + 1 is in the segment, and the
   match at p + 1 is longer, in which case p is a literal; without a match
   p is a literal.
4. Codes: the literal/length and distance codes (limit 15 bits) and the
   code-length code (7 bits) of ``huffman_lengths``: a two-queue Huffman
   tree over the used symbols in (frequency, symbol) order, depths clamped
   to the limit and the counts repaired as miniz does, the lengths handed
   out longest first in that order; fewer than two used symbols get two
   codes of one bit.  The code lengths are sent as one run-length coded
   sequence (``_rle``).
5. The block: dynamic (BTYPE 10) with BFINAL on the member's last
   segment; after any other segment an empty stored block (a sync flush),
   so that every segment ends on a byte.  Where stored blocks of at most
   65,535 bytes are shorter, they are sent instead.

The member's CRC-32 is each segment's combined in order
(``crc32_combine``, zlib's).

**The card.**  ``deflate_stream`` runs the members' segments in pieces of
at most ``PIECE`` (``plan``), so its scratch is fixed whatever the table's
size: a piece's bytes, each member's with the ``WIN`` before its first
segment there, are copied in, three kernels run (the chains, one CTA a
segment that parses, codes and packs its bits, and a gather of the
segments into one buffer with the CRCs combined), and the compressed bytes
come back into pinned host memory while the card codes the next piece.
``Deflater`` holds those steps; ``LAUNCHES`` counts the pieces launched.
A CUDA device launches or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cudabuild

SEG = 1 << 16  # input bytes a segment
WIN = 1 << 15  # the farthest a match reaches back
HASH_BITS = 15
CHAIN = 16  # candidates a match search walks
LAZY = 32  # a match this long is taken without looking one position ahead
TOO_FAR = 4096  # a 3-byte match farther back than this is no match
MAX_MATCH = 258
STORED_MAX = 65535  # bytes a stored block holds
PIECE = 1024  # segments a launch: the card's scratch holds one piece
OUT_STRIDE = SEG + 64  # bytes of scratch a segment's output has on the card
ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)

LAUNCHES = 0


def _length_code(n: int) -> int:
    """A match length's code, 0-28 (symbol 257 + code)."""
    if n == MAX_MATCH:
        return 28
    x = n - 3
    if x < 8:
        return x
    top = x.bit_length() - 1
    return 4 * (top - 1) + ((x >> (top - 2)) & 3)


def _length_base(c: int) -> int:
    return MAX_MATCH if c == 28 else c + 3 if c < 8 else 3 + ((4 + (c & 3)) << ((c >> 2) - 1))


def _length_extra(c: int) -> int:
    return 0 if c < 8 or c == 28 else (c >> 2) - 1


def _dist_code(d: int) -> int:
    x = d - 1
    if x < 4:
        return x
    top = x.bit_length() - 1
    return 2 * top + ((x >> (top - 1)) & 1)


def _dist_base(c: int) -> int:
    return c + 1 if c < 4 else 1 + ((2 + (c & 1)) << ((c >> 1) - 1))


def _dist_extra(c: int) -> int:
    return 0 if c < 4 else (c >> 1) - 1


LEXT = [_length_extra(c) for c in range(29)]
DEXT = [_dist_extra(c) for c in range(30)]


def prev_links(data: np.ndarray) -> np.ndarray:
    """Rule 1: for each position, the distance (1..WIN) to the latest
    earlier position of the same hash, 0 if none is that near; positions
    without three bytes have no hash and 0."""
    n = len(data)
    prev = np.zeros(n, np.int64)
    if n >= 3:
        b = data.astype(np.int64)
        h = ((b[:-2] << 10) ^ (b[1:-1] << 5) ^ b[2:]) & ((1 << HASH_BITS) - 1)
        order = np.argsort(h, kind="stable")
        same = h[order[1:]] == h[order[:-1]]
        cur, pre = order[1:][same], order[:-1][same]
        near = cur - pre <= WIN
        prev[cur[near]] = (cur - pre)[near]
    return prev


def _match_len(buf: bytes, q: int, p: int, most: int) -> int:
    """The common prefix of the bytes at q and p, up to ``most``; 0 where
    it is under 3 (no match either way)."""
    if buf[q:q + 3] != buf[p:p + 3]:
        return 0
    if buf[q:q + most] == buf[p:p + most]:
        return most
    lo, hi = 3, most  # buf[q:q+lo] == buf[p:p+lo], buf[q:q+hi] != buf[p:p+hi]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if buf[q:q + mid] == buf[p:p + mid]:
            lo = mid
        else:
            hi = mid
    return lo


def find(buf: bytes, prev, p: int, end: int) -> tuple[int, int]:
    """Rule 2: (length, distance) of the match at p in a segment ending at
    ``end``, (0, 0) for none."""
    most = min(MAX_MATCH, end - p)
    if most < 3 or not prev[p]:
        return 0, 0
    q, best, dist = p - prev[p], 0, 0
    for _ in range(CHAIN):
        n = _match_len(buf, q, p, most)
        if n > best:
            best, dist = n, p - q
            if best >= most:
                break
        if not prev[q]:
            break
        q -= prev[q]
        if p - q > WIN:
            break
    if best < 3 or (best == 3 and dist > TOO_FAR):
        return 0, 0
    return best, dist


def parse(buf: bytes, prev, start: int, end: int) -> list[tuple[int, int, int]]:
    """Rule 3: the segment's tokens, (position, length, distance) in order;
    length 0 is a literal."""
    tokens, p, ahead = [], start, (-1, 0, 0)
    while p < end:
        n, d = ahead[1:] if ahead[0] == p else find(buf, prev, p, end)
        if n >= 3 and n < LAZY and p + 1 < end:
            ahead = (p + 1, *find(buf, prev, p + 1, end))
            if ahead[1] > n:
                n = 0
        if n >= 3:
            tokens.append((p, n, d))
            p += n
        else:
            tokens.append((p, 0, 0))
            p += 1
    return tokens


def huffman_lengths(freqs, limit: int) -> list[int]:
    """Rule 4: code lengths of at most ``limit`` bits for ``freqs``."""
    n = len(freqs)
    lengths = [0] * n
    used = [i for i in range(n) if freqs[i]]
    if len(used) < 2:
        for i in (used + [i for i in range(n) if i not in used])[:2]:
            lengths[i] = 1
        return lengths
    order = sorted(used, key=lambda i: (freqs[i], i))
    m = len(order)
    weight = [freqs[i] for i in order] + [0] * (m - 1)
    parent = [0] * (2 * m - 1)
    leaf, node, made = 0, m, m
    for _ in range(m - 1):
        pair = []
        for _ in range(2):  # the lighter of the two queues' fronts, a leaf on a tie
            if leaf < m and (node >= made or weight[leaf] <= weight[node]):
                pair.append(leaf)
                leaf += 1
            else:
                pair.append(node)
                node += 1
        weight[made] = weight[pair[0]] + weight[pair[1]]
        parent[pair[0]] = parent[pair[1]] = made
        made += 1
    depth = [0] * (2 * m - 1)
    for i in range(2 * m - 3, -1, -1):
        depth[i] = depth[parent[i]] + 1
    count = [0] * (limit + 1)
    for i in range(m):
        count[min(depth[i], limit)] += 1
    total = sum(count[b] << (limit - b) for b in range(1, limit + 1))
    while total != 1 << limit:
        count[limit] -= 1
        for b in range(limit - 1, 0, -1):
            if count[b]:
                count[b] -= 1
                count[b + 1] += 2
                break
        total -= 1
    j = 0
    for b in range(limit, 0, -1):
        for _ in range(count[b]):
            lengths[order[j]] = b
            j += 1
    return lengths


def canonical_codes(lengths) -> list[int]:
    """Deflate's canonical codes, bit-reversed for LSB-first packing."""
    count = [0] * 16
    for b in lengths:
        count[b] += 1
    count[0] = 0
    nxt, code = [0] * 16, 0
    for b in range(1, 16):
        code = (code + count[b - 1]) << 1
        nxt[b] = code
    codes = [0] * len(lengths)
    for i, b in enumerate(lengths):
        if b:
            codes[i] = int(f"{nxt[b]:0{b}b}"[::-1], 2)
            nxt[b] += 1
    return codes


def _rle(seq) -> list[tuple[int, int]]:
    """The code lengths as (symbol, extra) of the code-length alphabet:
    16 repeats the previous length 3-6 times, 17 and 18 give 3-10 and
    11-138 zeros."""
    out, i = [], 0
    while i < len(seq):
        v, r = seq[i], 1
        while i + r < len(seq) and seq[i + r] == v:
            r += 1
        i += r
        if v == 0:
            while r >= 11:
                t = min(r, 138)
                out.append((18, t - 11))
                r -= t
            if r >= 3:
                out.append((17, r - 3))
                r = 0
            out += [(0, 0)] * r
        else:
            out.append((v, 0))
            r -= 1
            while r >= 3:
                t = min(r, 6)
                out.append((16, t - 3))
                r -= t
            out += [(v, 0)] * r
    return out


RLE_EXTRA = {16: 2, 17: 3, 18: 7}


class _Bits:
    """LSB-first bit packer."""

    def __init__(self) -> None:
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v: int, nb: int) -> None:
        self.acc |= v << self.n
        self.n += nb
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def align(self) -> None:
        if self.n:
            self.put(0, 8 - self.n)


def encode_segment(buf: bytes, prev, start: int, end: int, last: bool) -> tuple[bytes, bool]:
    """Rules 3-5 for the segment [start, end) of a member's bytes ``buf``:
    its deflate bytes and whether it went stored."""
    tokens = parse(buf, prev, start, end)
    lf, df = [0] * 286, [0] * 30
    lf[256] = 1
    for p, n, d in tokens:
        if n:
            lf[257 + _length_code(n)] += 1
            df[_dist_code(d)] += 1
        else:
            lf[buf[p]] += 1
    ll, dl = huffman_lengths(lf, 15), huffman_lengths(df, 15)
    hlit = max([i + 1 for i in range(257, 286) if ll[i]] + [257])
    hdist = max([i + 1 for i in range(30) if dl[i]] + [1])
    rle = _rle(ll[:hlit] + dl[:hdist])
    cf = [0] * 19
    for s, _ in rle:
        cf[s] += 1
    cl = huffman_lengths(cf, 7)
    hclen = max([i + 1 for i in range(4, 19) if cl[ORDER[i]]] + [4])
    bits = 17 + 3 * hclen + sum(cl[s] + RLE_EXTRA.get(s, 0) for s, _ in rle)
    bits += sum(f * b for f, b in zip(lf, ll)) + sum(f * (b + e) for f, b, e in zip(df, dl, DEXT))
    bits += sum(lf[257 + c] * LEXT[c] for c in range(29))
    dyn = -(-bits // 8) if last else -(-(bits + 3) // 8) + 4
    n = end - start
    blocks = max(1, -(-n // STORED_MAX))
    w = _Bits()
    if 5 * blocks + n < dyn:
        for k in range(blocks):
            a = start + k * STORED_MAX
            m = min(STORED_MAX, end - a)
            w.put(int(last and k == blocks - 1), 3)
            w.align()
            w.out += m.to_bytes(2, "little") + (m ^ 0xFFFF).to_bytes(2, "little") + buf[a:a + m]
        return bytes(w.out), True
    lc, dc, cc = canonical_codes(ll), canonical_codes(dl), canonical_codes(cl)
    w.put(int(last), 1)
    w.put(2, 2)
    w.put(hlit - 257, 5)
    w.put(hdist - 1, 5)
    w.put(hclen - 4, 4)
    for i in range(hclen):
        w.put(cl[ORDER[i]], 3)
    for s, x in rle:
        w.put(cc[s], cl[s])
        if s in RLE_EXTRA:
            w.put(x, RLE_EXTRA[s])
    for p, n, d in tokens:
        if n:
            c = _length_code(n)
            w.put(lc[257 + c], ll[257 + c])
            w.put(n - _length_base(c), LEXT[c])
            c = _dist_code(d)
            w.put(dc[c], dl[c])
            w.put(d - _dist_base(c), DEXT[c])
        else:
            w.put(lc[buf[p]], ll[buf[p]])
    w.put(lc[256], ll[256])
    if not last:  # the sync flush: an empty stored block
        w.put(0, 3)
        w.align()
        w.out += b"\x00\x00\xff\xff"
    w.align()
    assert len(w.out) == dyn
    return bytes(w.out), False


def _multmodp(a: int, b: int) -> int:
    """a * b modulo CRC-32's polynomial, in zlib's reflected order."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ 0xEDB88320 if b & 1 else b >> 1


def _xpow8n(n: int) -> int:
    """x^(8 n) modulo the polynomial."""
    p, sq = 1 << 31, 1 << 23
    while n:
        if n & 1:
            p = _multmodp(sq, p)
        sq = _multmodp(sq, sq)
        n >>= 1
    return p


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of A + B from crc(A), crc(B) and len(B) (zlib's
    ``crc32_combine``, which Python's zlib does not expose)."""
    return _multmodp(_xpow8n(len2), crc1) ^ crc2


def deflate_plain(data, segments: int | None = None) -> tuple[bytes, int, int, int]:
    """The card's stream for a member's bytes, segment by segment: (raw
    deflate bytes, CRC-32, segments, stored segments).  ``segments``
    stops after that many (the stream is then cut short; the CRC covers
    those segments)."""
    buf = bytes(data)
    prev = prev_links(np.frombuffer(buf, np.uint8)).tolist()
    n = len(buf)
    nseg = max(1, -(-n // SEG))
    out, crc, stored = [], 0, 0
    for i in range(nseg if segments is None else min(segments, nseg)):
        s, e = i * SEG, min(n, (i + 1) * SEG)
        seg, st = encode_segment(buf, prev, s, e, i == nseg - 1)
        out.append(seg)
        stored += st
        crc = crc32_combine(crc, zlib.crc32(buf[s:e]), e - s)
    return b"".join(out), crc, len(out), stored


# --- the card ----------------------------------------------------------------


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    lib = cudabuild.load("fkdeflate", ("deflate.cu",))
    lib.fk_deflate_piece.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int,
    ] + [ctypes.c_void_p] * 7
    lib.fk_deflate_piece.restype = ctypes.c_int
    return lib


class Piece(NamedTuple):
    """What one launch deflates.  copies: (member, first byte, end, buffer
    offset) of each member's bytes it holds, from ``WIN`` before its first
    segment there (or the member's start); nbuf: the buffer's bytes (each
    member's copy starts 64-byte aligned); ranges: int64 [4, R], the chain
    kernel's 64 KiB blocks of each copy (start, end, the copy's start, its
    end); segs: int64 [4, S], the segments in stream order (start, end,
    whether the member's last, member), in buffer offsets."""

    copies: list
    nbuf: int
    ranges: np.ndarray
    segs: np.ndarray


def plan(sizes, piece: int) -> list[Piece]:
    """The launches that deflate members of ``sizes`` bytes, ``piece``
    segments at most each, the members' segments in order."""
    segments = [(m, k * SEG, min(n, (k + 1) * SEG))
                for m, n in enumerate(sizes) for k in range(max(1, -(-n // SEG)))]
    pieces = []
    for i in range(0, len(segments), piece):
        chunk = segments[i:i + piece]
        copies, ranges, segs, at = [], [], [], 0
        for m in dict.fromkeys(seg[0] for seg in chunk):
            mine = [seg for seg in chunk if seg[0] == m]
            lo, hi = max(0, mine[0][1] - WIN), mine[-1][2]
            copies.append((m, lo, hi, at))
            end = at + hi - lo
            ranges += [(a, min(a + SEG, end), at, end) for a in range(at, end, SEG)]
            segs += [(at + s - lo, at + e - lo, e == sizes[m], m) for _, s, e in mine]
            at += -(-(hi - lo) // 64) * 64
        pieces.append(Piece(copies, at, np.array(ranges, np.int64).reshape(-1, 4).T.copy(),
                            np.array(segs, np.int64).reshape(-1, 4).T.copy()))
    return pieces


class Deflater:
    """The card's side of ``deflate_stream`` for members ((``.npy`` header
    bytes, array bytes) each) on the CUDA ``device``: the pieces
    (``plan``), scratch for two in flight, and a piece's three steps.
    ``stage`` copies its bytes in on a side stream, ``run`` launches its
    kernels on the device's current stream once they are in, and
    ``collect`` brings its compressed bytes back; ``totals`` reads each
    member's CRC-32, segments and stored segments after the last.  A piece
    takes slot k % 2, so piece k + 2 is staged only after piece k is
    collected."""

    def __init__(self, members, device) -> None:
        self.device = device
        self.parts = [(np.frombuffer(bytearray(head), np.uint8),
                       np.asarray(data).reshape(-1).view(np.uint8)) for head, data in members]
        self.pieces = plan([len(h) + len(d) for h, d in self.parts], PIECE)
        nbuf = max(p.nbuf for p in self.pieces)
        nseg = max(p.segs.shape[1] for p in self.pieces)
        self.main = torch.cuda.current_stream(device)
        self.side = torch.cuda.Stream(device)
        self.prev = torch.empty(nbuf, dtype=torch.int16, device=device)
        self.memo = torch.empty(nbuf, dtype=torch.int32, device=device)
        self.out = torch.empty(nseg * OUT_STRIDE, dtype=torch.uint8, device=device)
        self.state = torch.zeros(3 * len(members), dtype=torch.int64, device=device)
        self.slots = [{"buf": torch.empty(nbuf + 16, dtype=torch.uint8, device=device),
                       "dst": torch.empty(nseg * OUT_STRIDE, dtype=torch.uint8, device=device),
                       "meta": torch.empty(3 * nseg, dtype=torch.int32, device=device)}
                      for _ in range(min(2, len(self.pieces)))]

    def stage(self, k: int) -> None:
        pc, slot = self.pieces[k], self.slots[k % 2]
        with torch.cuda.device(self.device), torch.cuda.stream(self.side):
            for m, lo, hi, at in pc.copies:  # the header's bytes, then the array's
                head, data = self.parts[m]
                for src, base in ((head, 0), (data, len(head))):
                    a, b = max(lo, base) - base, min(hi, base + len(src)) - base
                    if b > a:
                        with warnings.catch_warnings():
                            # a read-only array is only read here: the copy's source
                            warnings.simplefilter("ignore", UserWarning)
                            part = torch.from_numpy(src[a:b])
                        slot["buf"][at + base + a - lo:at + base + b - lo].copy_(part)
            tables = np.concatenate([pc.ranges.ravel(), pc.segs.ravel()])
            slot["tables"] = torch.from_numpy(tables).to(self.device)
            slot["ready"] = self.side.record_event()

    def run(self, k: int) -> None:
        global LAUNCHES
        pc, slot = self.pieces[k], self.slots[k % 2]
        nr, ns = pc.ranges.shape[1], pc.segs.shape[1]
        with torch.cuda.device(self.device):
            self.main.wait_event(slot["ready"])
            rc = library().fk_deflate_piece(
                slot["buf"].data_ptr(), pc.nbuf, slot["tables"].data_ptr(), nr,
                slot["tables"].data_ptr() + 32 * nr, ns, self.prev.data_ptr(),
                self.memo.data_ptr(), self.out.data_ptr(), slot["meta"].data_ptr(),
                slot["dst"].data_ptr(), self.state.data_ptr(), self.main.cuda_stream)
            if rc:
                raise RuntimeError(f"fk_deflate_piece failed: CUDA error {rc}")
            slot["done"] = self.main.record_event()
        LAUNCHES += 1

    def collect(self, k: int):
        """Yield (member, its next compressed bytes as a uint8 array over
        pinned host memory) for piece k."""
        pc, slot = self.pieces[k], self.slots[k % 2]
        with torch.cuda.device(self.device), torch.cuda.stream(self.side):
            self.side.wait_event(slot["done"])
            size = slot["meta"][:pc.segs.shape[1]].cpu().numpy().astype(np.int64)
            ends = np.cumsum(size)
            host = torch.empty(int(ends[-1]), dtype=torch.uint8, pin_memory=True)
            host.copy_(slot["dst"][:int(ends[-1])])
        got = host.numpy()
        for m in dict.fromkeys(pc.segs[3].tolist()):  # a member's segments are adjacent
            idx = np.flatnonzero(pc.segs[3] == m)
            yield m, got[ends[idx[0]] - size[idx[0]]:ends[idx[-1]]]

    def totals(self) -> list[tuple[int, int, int]]:
        """(CRC-32, segments, stored segments) a member."""
        st = self.state.cpu().tolist()
        return [(st[3 * m] & 0xFFFFFFFF, st[3 * m + 2], st[3 * m + 1])
                for m in range(len(self.parts))]


def deflate_stream(members, device):
    """Deflate members ((``.npy`` header bytes, array bytes) each) on the
    CUDA ``device``, yielding (member, its next compressed bytes as a uint8
    array over pinned host memory) in stream order as each piece comes
    back, then (None, [(CRC-32, segments, stored segments) a member]).

    Two pieces are in flight: while the card codes one, the next piece's
    bytes are copied in on a second stream, and the caller takes the piece
    before it.  Launches raise on a CUDA error; nothing falls back."""
    d = Deflater(members, device)
    d.stage(0)
    d.run(0)
    for k in range(len(d.pieces)):
        if k + 1 < len(d.pieces):
            d.stage(k + 1)
            d.run(k + 1)
        yield from d.collect(k)
    yield None, d.totals()


def deflate(members, device) -> list[tuple[list, int, int, int]]:
    """``deflate_stream`` gathered: for each member (its compressed bytes,
    uint8 arrays in order; CRC-32; segments; stored segments)."""
    coded = [[] for _ in members]
    for m, got in deflate_stream(members, device):
        if m is None:
            return [(c, *r) for c, r in zip(coded, got)]
        coded[m].append(got)
