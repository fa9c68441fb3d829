"""ctypes bindings for the native ingest library (fkingest.cpp) — the
port's copy of ``fastkmer_tpu.ingest.native``.

Built with g++ at first use into ``build/fastkmer_tpu_torch/``
(utils.nativebuild); when no compiler is available callers fall back to
the pure-python parser in ingest.fasta, which stays the semantic
reference (both paths give byte-identical batches).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ...utils import nativebuild

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fkingest.cpp")


@functools.cache
def _load():
    so = nativebuild.build("fkingest", _SRC, extra_flags=("-lz",))
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for fn in ("fk_parse_fasta", "fk_parse_fastq"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int64
        f.argtypes = [u8p, ctypes.c_int64, u8p, i64p, ctypes.c_int64]
    lib.fk_dump_lines.restype = ctypes.c_int64
    lib.fk_dump_lines.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, u8p,
    ]
    lib.fk_gunzip.restype = ctypes.c_int64
    lib.fk_gunzip.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    return lib


def available() -> bool:
    return _load() is not None


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native ingest unavailable")
    return lib


def parse_file(path: str, fmt: str = "fasta"):
    """Parse+encode a whole file natively.

    Returns (codes: uint8[n_total], rec_starts: int64[n_records+1]).
    Raises RuntimeError when the native library is unavailable or the file
    is malformed — callers fall back to the python parser.
    """
    lib = _lib()
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.shape[0] >= 2 and raw[0] == 0x1F and raw[1] == 0x8B:
        raw = gunzip(raw)  # native zlib inflate (multi-member gzip)
    n = raw.shape[0]
    codes = np.empty(n, dtype=np.uint8)
    # record-count bound: one record per '>' / '@' header line, +1 slack
    max_recs = int((raw == (ord(">") if fmt == "fasta" else ord("@"))).sum()) + 2
    starts = np.empty(max_recs + 1, dtype=np.int64)
    fn = lib.fk_parse_fasta if fmt == "fasta" else lib.fk_parse_fastq
    nrec = fn(
        _as_u8p(raw),
        ctypes.c_int64(n),
        _as_u8p(codes),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(max_recs),
    )
    if nrec < 0:
        raise RuntimeError(f"native parse failed with code {nrec}")
    total = starts[nrec]
    return codes[:total], starts[: nrec + 1].copy()


def dump_lines(words: np.ndarray, counts: np.ndarray, k: int) -> bytes:
    """Decode packed k-mer rows + counts into ``<KMER>\\t<count>\\n`` bytes
    (the reference's per-bin line format) in one native pass."""
    lib = _lib()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n, W = words.shape
    out = np.empty(n * (k + 22), dtype=np.uint8)
    m = lib.fk_dump_lines(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), ctypes.c_int32(k), ctypes.c_int32(W),
        _as_u8p(out),
    )
    return out[:m].tobytes()


def gunzip(raw: np.ndarray) -> np.ndarray:
    """Native gzip inflate; grows the output buffer on -1 and retries."""
    lib = _lib()
    cap = max(4 * int(raw.shape[0]), 1 << 16)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        m = lib.fk_gunzip(
            _as_u8p(raw), ctypes.c_int64(raw.shape[0]),
            _as_u8p(out), ctypes.c_int64(cap),
        )
        if m == -1:
            cap *= 2
            continue
        if m < 0:
            raise RuntimeError(f"native gunzip failed with code {m}")
        return out[:m]
