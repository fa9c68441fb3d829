"""Fixed-shape batching of encoded reads — the port's copy of what it uses
of ``fastkmer_tpu.ingest.batch`` (the dense packing of ``batch_file``).

Reads become fixed-capacity [R, L] uint8 code matrices padded with the
invalid code 4.  Window validity downstream is "window contains no code
>= 4" (the array form of the reference's N-split,
SparkBinKmerCounter.scala:78-97), so padding needs no length mask.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..core import bits


class _DensePacker:
    """Greedy row filler: multiple reads per row, separated by ONE
    INVALID_CODE cell.

    Exactness: a k-window crossing a separator contains code 4 and is
    discarded by the same validity logic that splits on 'N' runs
    (package.scala:739-754), so a record boundary costs one cell instead
    of a whole padded row.
    """

    def __init__(self, reads_per_batch: int, read_len: int):
        self.R, self.L = reads_per_batch, read_len
        self._new()

    def _new(self):
        self.buf = np.full((self.R, self.L), bits.INVALID_CODE, dtype=np.uint8)
        self.row = 0
        self.col = 0
        self.n_reads = 0
        self.n_bases = 0

    def add(self, codes: np.ndarray):
        """Place one encoded read; yields a full batch when one completes."""
        n = codes.shape[0]
        if n > self.L:
            raise ValueError(f"read of length {n} > batch read_len {self.L}")
        need = n if self.col == 0 else n + 1  # +1 separator cell
        if self.col + need > self.L:
            self.row += 1
            self.col = 0
            need = n
            if self.row == self.R:
                out = (self.buf, self.n_reads, self.n_bases)
                self._new()
                yield out
        start = self.col + (need - n)
        self.buf[self.row, start : start + n] = codes
        self.col = start + n
        self.n_reads += 1
        self.n_bases += n

    def flush(self):
        if self.n_reads:
            yield self.buf, self.n_reads, self.n_bases
            self._new()


def batch_file(
    path: str,
    sequence_type: int,
    k: int,
    reads_per_batch: int,
    read_len: int,
    use_native: bool | None = None,
) -> Iterator[Tuple[np.ndarray, int, int]]:
    """File -> densely packed [R, L] code batches, as (codes, n_reads,
    n_bases); a fresh buffer per batch.

    Prefers the native C++ parse+encode path (ingest.native) when built;
    falls back to the python parser.  Both give identical batches.
    ``use_native`` True raises instead of falling back, False skips it.
    """
    from . import fasta

    if use_native is not False:
        try:
            from . import native

            if native.available():
                fmt = fasta.sniff_format(path)
                codes, starts = native.parse_file(path, fmt)
                return _batches_from_parsed(codes, starts, k, reads_per_batch, read_len)
        except Exception:
            if use_native:
                raise
    packer = _DensePacker(reads_per_batch, read_len)
    reads = (seq for _, seq in fasta.iter_reads(path, sequence_type, k, chunk_len=read_len))
    return _packed(packer, (bits.encode_ascii(r) for r in reads))


def _packed(packer: _DensePacker, reads) -> Iterator[Tuple[np.ndarray, int, int]]:
    for codes in reads:
        yield from packer.add(codes)
    yield from packer.flush()


def _batches_from_parsed(
    codes: np.ndarray, starts: np.ndarray, k: int, reads_per_batch: int, read_len: int,
) -> Iterator[Tuple[np.ndarray, int, int]]:
    """Assemble batches from natively parsed (codes, record offsets):
    records longer than read_len are chunked with k-1 overlap (the long-mode
    PartialSequence semantics), shorter ones pass through."""
    stride = read_len - (k - 1)
    rows: list[tuple[int, int]] = []  # (offset, length)
    for i in range(starts.shape[0] - 1):
        off, end = int(starts[i]), int(starts[i + 1])
        ln = end - off
        if ln <= read_len:
            rows.append((off, ln))
        else:
            pos = off
            while pos < end:
                rows.append((pos, min(read_len, end - pos)))
                if pos + read_len >= end:
                    break
                pos += stride
    return _packed(_DensePacker(reads_per_batch, read_len),
                   (codes[off : off + ln] for off, ln in rows))
