"""Host-side FASTA/FASTQ ingest — the port's copy of
``fastkmer_tpu.ingest.fasta``.

The replacement for the FASTdoop Hadoop input formats the reference relies
on (reference: SparkBinKmerCounter.scala:1009-1012):

* ``sequence_type=0`` (short mode) — every FASTA/FASTQ record is one read
  (``FASTAshortInputFileFormat`` -> ``Record``).
* ``sequence_type=1`` (long mode) — each sequence is split into chunks of at
  most ``chunk_len`` bases with a ``k-1``-base overlap between adjacent
  chunks (``FASTAlongInputFileFormat`` -> ``PartialSequence``).  The overlap
  makes chunking lossless: every k-window of the original sequence lies in
  exactly one chunk's "owned" region.

Embedded newlines/whitespace are stripped exactly like the reference's
``read.getValue.replaceAll("\\n", "")`` (SparkBinKmerCounter.scala:62-65).
Non-ACGT characters are kept (as code 4 after encoding); window validity
downstream splits on them (package.scala:739-754).

The native parser (``ingest.native``) is the fast path when built; this
module is the portable fallback (gzip included) and the semantic definition.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, Tuple

import numpy as np

from ..core import bits


def _open(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f)  # type: ignore[return-value]
    return f


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (header, sequence_bytes) per FASTA record; multi-line sequences
    are concatenated with all whitespace removed."""
    name = None
    parts: list[bytes] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(parts)
                name = line[1:].decode(errors="replace")
                parts = []
            else:
                parts.append(line)
        if name is not None:
            yield name, b"".join(parts)


def iter_fastq(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (header, sequence_bytes) per FASTQ record (quality discarded)."""
    with _open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            seq = f.readline().strip()
            f.readline()  # '+'
            f.readline()  # quality
            yield hdr[1:].strip().decode(errors="replace"), seq


def sniff_format(path: str) -> str:
    with _open(path) as f:
        first = f.read(1)
    if first == b"@":
        return "fastq"
    return "fasta"


def iter_records(path: str) -> Iterator[Tuple[str, bytes]]:
    if sniff_format(path) == "fastq":
        return iter_fastq(path)
    return iter_fasta(path)


def chunk_sequence(seq: bytes, k: int, chunk_len: int) -> Iterator[bytes]:
    """Split one sequence into <=chunk_len chunks overlapping by k-1 bases.

    Every window of length k starts in exactly one chunk's owned region
    [start, start + stride), so counting chunks independently is exact.
    """
    if chunk_len < 2 * k:
        raise ValueError("chunk_len must be >= 2k")
    n = len(seq)
    if n <= chunk_len:
        yield seq
        return
    stride = chunk_len - (k - 1)
    start = 0
    while start < n:
        yield seq[start : start + chunk_len]
        if start + chunk_len >= n:
            break
        start += stride


def iter_reads(
    path: str,
    sequence_type: int,
    k: int,
    chunk_len: int = 1 << 16,
) -> Iterator[Tuple[str, bytes]]:
    """Unified read stream: short records (sequence_type=0) or overlapping
    long-sequence chunks (sequence_type=1).  In short mode, reads longer than
    chunk_len are still chunked losslessly so batches stay fixed-shape."""
    for name, seq in iter_records(path):
        if sequence_type == 0 and len(seq) <= chunk_len:
            yield name, seq
        else:
            for i, chunk in enumerate(chunk_sequence(seq, k, chunk_len)):
                yield f"{name}#{i}", chunk


def encode_read(seq: bytes) -> np.ndarray:
    return bits.encode_ascii(seq)


def total_bases(path: str) -> int:
    return sum(len(s) for _, s in iter_records(path))


def file_size(path: str) -> int:
    return os.path.getsize(path)
