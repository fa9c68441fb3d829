"""Fixed-shape batching of encoded reads — the port's copy of what it uses
of ``fastkmer_tpu.ingest.batch``: ``batch_file`` (densely packed, or one
read a row), the packers of encoded reads (``batch_codes``: one read a
row; ``batch_codes_dense``), and the tagged packing of multisequence
ingest (``batch_codes_dense_tagged``).

Reads become fixed-capacity [R, L] uint8 code matrices padded with the
invalid code 4.  Window validity downstream is "window contains no code
>= 4" (the array form of the reference's N-split,
SparkBinKmerCounter.scala:78-97), so padding needs no length mask.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, Tuple

import numpy as np

from ..core import bits


def batch_codes(
    reads: Iterable[bytes | np.ndarray],
    reads_per_batch: int,
    read_len: int,
) -> Iterator[Tuple[np.ndarray, int, int]]:
    """Pack encoded reads one per row into [R, L] uint8 batches padded with
    INVALID_CODE -> (codes, n_reads, n_bases) per batch; the last batch
    keeps its empty rows, so every batch has one shape.  A read longer
    than ``read_len`` raises (chunk it upstream, ingest.fasta.iter_reads).
    One read a row keeps a read <-> row correspondence."""
    return _rows(map(_encoded, reads), reads_per_batch, read_len)


def _encoded(read: bytes | np.ndarray) -> np.ndarray:
    return read if isinstance(read, np.ndarray) else bits.encode_ascii(read)


def _rows(codes_iter, reads_per_batch: int, read_len: int):
    buf = np.full((reads_per_batch, read_len), bits.INVALID_CODE, dtype=np.uint8)
    row = n_bases = 0
    for codes in codes_iter:
        if codes.shape[0] > read_len:
            raise ValueError(f"read of length {codes.shape[0]} > batch read_len {read_len}")
        buf[row, : codes.shape[0]] = codes
        n_bases += codes.shape[0]
        row += 1
        if row == reads_per_batch:
            yield buf, row, n_bases
            buf = np.full((reads_per_batch, read_len), bits.INVALID_CODE, dtype=np.uint8)
            row = n_bases = 0
    if row > 0:
        yield buf, row, n_bases


class _DensePacker:
    """Greedy row filler: multiple reads per row, separated by ONE
    INVALID_CODE cell.

    Exactness: a k-window crossing a separator contains code 4 and is
    discarded by the same validity logic that splits on 'N' runs
    (package.scala:739-754), so a record boundary costs one cell instead
    of a whole padded row.

    Multisequence ingest tags each read with its sequence id: every row
    holds reads of ONE tag, so a per-ROW sid array labels every extracted
    window, and a row switches (wasting only its tail) when the tag
    changes.  Untagged reads all carry tag 0.
    """

    def __init__(self, reads_per_batch: int, read_len: int):
        self.R, self.L = reads_per_batch, read_len
        self._new()

    def _new(self):
        self.buf = np.full((self.R, self.L), bits.INVALID_CODE, dtype=np.uint8)
        self.sids = np.zeros(self.R, dtype=np.int32)
        self.row = 0
        self.col = 0
        self.n_reads = 0
        self.n_bases = 0

    def _advance_row(self):
        """Next row; -> the full batch when the last row was filled."""
        self.row += 1
        self.col = 0
        if self.row == self.R:
            out = (self.buf, self.sids, self.n_reads, self.n_bases)
            self._new()
            return out
        return None

    def add(self, codes: np.ndarray, tag: int = 0):
        """Place one encoded read; yields (codes, sids, n_reads, n_bases)
        when a batch completes."""
        n = codes.shape[0]
        if n > self.L:
            raise ValueError(f"read of length {n} > batch read_len {self.L}")
        if self.col > 0 and tag != int(self.sids[self.row]):
            full = self._advance_row()
            if full is not None:
                yield full
        need = n if self.col == 0 else n + 1  # +1 separator cell
        if self.col + need > self.L:
            full = self._advance_row()
            if full is not None:
                yield full
            need = n
        start = self.col + (need - n)
        self.buf[self.row, start : start + n] = codes
        self.sids[self.row] = tag
        self.col = start + n
        self.n_reads += 1
        self.n_bases += n

    def flush(self):
        if self.n_reads:
            yield self.buf, self.sids, self.n_reads, self.n_bases
            self._new()


def batch_codes_dense_tagged(
    tagged_reads: Iterable[tuple[int, bytes | np.ndarray]],
    reads_per_batch: int,
    read_len: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int, int]]:
    """(sid, read) stream -> (codes [R, L], sids [R], n_reads, n_bases)
    batches, densely packed with one sequence a row (_DensePacker)."""
    packer = _DensePacker(reads_per_batch, read_len)
    for tag, r in tagged_reads:
        yield from packer.add(_encoded(r), tag)
    yield from packer.flush()


def batch_codes_dense(
    reads: Iterable[bytes | np.ndarray],
    reads_per_batch: int,
    read_len: int,
) -> Iterator[Tuple[np.ndarray, int, int]]:
    """Like batch_codes but densely packed (_DensePacker): the same count
    tables in up to read_len / mean read length times fewer batches."""
    return _packed(_DensePacker(reads_per_batch, read_len), map(_encoded, reads))


def batch_file(
    path: str,
    sequence_type: int,
    k: int,
    reads_per_batch: int,
    read_len: int,
    use_native: bool | None = None,
    dense: bool = True,
    timer=None,
) -> Iterator[Tuple[np.ndarray, int, int]]:
    """File -> [R, L] code batches, as (codes, n_reads, n_bases); a fresh
    buffer per batch.  ``dense`` (default) packs several reads a row;
    False packs one read a row (batch_codes).

    Prefers the native C++ route (ingest.native) when built; falls back to
    the python parser.  Both give identical batches.  ``use_native`` True
    raises instead of falling back, False skips it.  The native route reads
    and encodes the whole file here, in the calling thread, and then fills
    each dense batch in one native call as the batches are taken (on the
    prefetch thread, under ``prefetched``); the python parser reads as the
    batches are taken.  A ``timer`` (utils.timing.StageTimer) holds this
    call in its span ``ingest_parse`` and counts each natively filled batch
    in ``native_pack_batches``.
    """
    from . import fasta

    with timer.span("ingest_parse") if timer else contextlib.nullcontext():
        if use_native is not False:
            try:
                from . import native

                if native.available():
                    fmt = fasta.sniff_format(path)
                    codes, starts = native.parse_file(path, fmt)
                    if dense:
                        return _batches_from_parsed(codes, starts, k, reads_per_batch,
                                                    read_len, timer)
                    return _rows(_chunks(codes, starts, k, read_len), reads_per_batch,
                                 read_len)
            except Exception:
                if use_native:
                    raise
        reads = (seq for _, seq in fasta.iter_reads(path, sequence_type, k,
                                                    chunk_len=read_len))
        return (batch_codes_dense if dense else batch_codes)(reads, reads_per_batch, read_len)


def _packed(packer: _DensePacker, reads) -> Iterator[Tuple[np.ndarray, int, int]]:
    for codes in reads:
        for buf, _, n_reads, n_bases in packer.add(codes):
            yield buf, n_reads, n_bases
    for buf, _, n_reads, n_bases in packer.flush():
        yield buf, n_reads, n_bases


def _batches_from_parsed(
    codes: np.ndarray, starts: np.ndarray, k: int, reads_per_batch: int, read_len: int,
    timer=None,
) -> Iterator[Tuple[np.ndarray, int, int]]:
    """Natively parsed (codes, record offsets) -> densely packed batches,
    one ``native.pack_dense`` call a batch: _chunks packed by _DensePacker,
    byte for byte."""
    from . import native

    cursor = np.zeros(2, dtype=np.int64)
    while True:
        buf = np.empty((reads_per_batch, read_len), dtype=np.uint8)
        n_reads, n_bases = native.pack_dense(codes, starts, k, buf, cursor)
        if not n_reads:
            return
        if timer:
            timer.count("native_pack_batches")
        yield buf, n_reads, n_bases


def _chunks(codes: np.ndarray, starts: np.ndarray, k: int,
            read_len: int) -> Iterator[np.ndarray]:
    """The reads of natively parsed (codes, record offsets): records longer
    than read_len are chunked with k-1 overlap (the long-mode
    PartialSequence semantics), shorter ones pass through."""
    stride = read_len - (k - 1)
    for i in range(starts.shape[0] - 1):
        off, end = int(starts[i]), int(starts[i + 1])
        pos = off
        while True:
            yield codes[pos : min(pos + read_len, end)]
            if pos + read_len >= end:
                break
            pos += stride
