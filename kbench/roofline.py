"""Peaks of the card and the bytes a kernel needs.

A kernel's least time is the larger of its operations over the peak rate
and its bytes over the peak bandwidth; the count-mode extract does no
arithmetic worth the name, so its bound is bytes.  Each input byte is
counted read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


def extract_count_bytes(R: int, L: int, k: int) -> tuple[int, int]:
    """Kernel A (the count-mode extract) on one [R, L] batch of uint8
    codes: (bytes in, bytes out).  It writes one int32 lane per word of the
    canonical k-mer, W = ceil(k / 16), for each of the L - k + 1 window
    starts of every row, plus a flag lane when k % 16 == 0."""
    lanes = -(-k // 16) + (k % 16 == 0)
    return R * L, R * (L - k + 1) * lanes * 4


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
