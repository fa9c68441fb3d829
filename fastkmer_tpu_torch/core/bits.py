"""Host-side (numpy) bit-level core — the port's copy of what it uses of
``fastkmer_tpu.core.bits``: ASCII <-> 2-bit codes, the word count of a
k-mer, the empty count table, the decode of packed word rows for output, and the scalar helpers
(reverse complement of a packed m-mer, pack and unpack of one k-mer).

Bases are 2-bit codes A=0 C=1 G=2 T=3; anything else (N, lowercase, ...)
is the invalid code 4 (package.scala:697).  A k-mer is ``W = ceil(k/16)``
uint32 words; base 0 sits in the highest bits of word 0 and the last word
is zero-padded in its LOW bits, so lexicographic string order is the
numeric order of the word tuple.  The torch-side bit operations live in
``core.tbits``.
"""

from __future__ import annotations

import numpy as np

BASES_PER_WORD = 16  # 2 bits/base in a uint32
INVALID_CODE = 4

# ASCII -> 2-bit code lookup (256 entries); invalid = 4.
# Mirrors nucleotideBitmasks (package.scala:18-22) + notANucleotide (:697).
ASCII_TO_CODE = np.full(256, INVALID_CODE, dtype=np.uint8)
for _ch, _code in ((ord("A"), 0), (ord("C"), 1), (ord("G"), 2), (ord("T"), 3)):
    ASCII_TO_CODE[_ch] = _code

# 2-bit code -> ASCII char (package.scala:24-34)
CODE_TO_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8).copy()


def encode_ascii(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes (invalid chars -> 4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return ASCII_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode_codes(codes: np.ndarray) -> str:
    codes = np.asarray(codes, dtype=np.uint8)
    if np.any(codes >= 4):
        raise ValueError("cannot decode invalid codes")
    return CODE_TO_ASCII[codes].tobytes().decode()


def reverse_complement_int(v: int, length: int) -> int:
    """RC of a 2-bit-packed integer m-mer (reference: package.scala:103-115)."""
    rev = 0
    for _ in range(length):
        rev = (rev << 2) | (3 - (v & 3))
        v >>= 2
    return rev


def num_words(k: int) -> int:
    return -(-k // BASES_PER_WORD)


def empty_table(lanes: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The count table with no rows: (words [0, lanes] uint32, counts int64,
    bins int32)."""
    return np.zeros((0, lanes), np.uint32), np.zeros(0, np.int64), np.zeros(0, np.int32)


def pack_kmer_words(codes: np.ndarray, k: int) -> tuple[int, ...]:
    """Pack k codes into W big-endian uint32 words (last word low-padded)."""
    codes = np.asarray(codes, dtype=np.uint64)
    if codes.shape[0] != k or np.any(codes >= 4):
        raise ValueError(f"pack_kmer_words needs {k} codes in 0..3")
    words = []
    for w in range(num_words(k)):
        val = 0
        for j in range(BASES_PER_WORD):
            pos = w * BASES_PER_WORD + j
            val = (val << 2) | (int(codes[pos]) if pos < k else 0)
        words.append(val & 0xFFFFFFFF)
    return tuple(words)


def unpack_kmer_words(words, k: int) -> np.ndarray:
    """Inverse of pack_kmer_words -> uint8 codes of length k."""
    out = np.empty(k, dtype=np.uint8)
    for pos in range(k):
        w, j = divmod(pos, BASES_PER_WORD)
        out[pos] = (int(words[w]) >> (2 * (BASES_PER_WORD - 1 - j))) & 3
    return out


def words_to_str(words, k: int) -> str:
    return decode_codes(unpack_kmer_words(words, k))


def decode_words_batch(words: np.ndarray, k: int) -> list[bytes]:
    """Vectorized decode of [N, W] uint32 word rows -> list of ASCII k-mers
    (one table lookup over an [N, k] code matrix)."""
    words = np.asarray(words, dtype=np.uint32)
    N, W = words.shape
    assert W == num_words(k)
    pos = np.arange(k)
    widx = pos // BASES_PER_WORD
    shift = (2 * (BASES_PER_WORD - 1 - pos % BASES_PER_WORD)).astype(np.uint32)
    codes = (words[:, widx] >> shift[None, :]) & np.uint32(3)
    ascii_mat = CODE_TO_ASCII[codes]
    flat = ascii_mat.tobytes()
    return [flat[i * k:(i + 1) * k] for i in range(N)]
