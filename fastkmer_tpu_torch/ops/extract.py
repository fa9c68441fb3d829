"""Stage 1 — canonical k-mer / signature / bin extraction in plain torch.

The port of ``fastkmer_tpu.ops.extract``.  For every window start i of a
[R, L] batch of 2-bit codes (>= 4 is invalid or padding):

    valid(i) = no invalid base in [i, i+k)
    sig(i)   = min over j in [i, i+k-m] of norm(m-mer at j)
    bin(i)   = hash_to_bucket(sig(i), B)
    kmer(i)  = min(forward words, reverse-complement words)   # canonical

This is the plain version of the count-mode CUDA kernel
(``ops.cuda_extract``) and its reference in the tests.  Words at invalid
positions follow the JAX package's padding (code 4 masked to 0), so they
agree with the kernel only where ``valid``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import tbits
from ..core.bits import BASES_PER_WORD, num_words
from . import windows


class Extracted(NamedTuple):
    """Per-position stage-1 output, flattened over (read, position).

    words: [N, W] int32 canonical k-mer (uint32 bit patterns), big-endian words
    bins:  [N] int32 target bin in [0, B)
    sigs:  [N] int32 minimizer signature value (< 2^31)
    valid: [N] bool window validity
    """

    words: torch.Tensor
    bins: torch.Tensor
    sigs: torch.Tensor
    valid: torch.Tensor


def canonical_words(codes2: torch.Tensor, k: int) -> tuple[list, list]:
    """Packed forward and RC words (int64 [R, P] each) for every window
    start, P = L - 16·W + 1.  codes2 must be padded so indices up to
    P-1 + 16·W - 1 exist."""
    W = num_words(k)
    rem = k - BASES_PER_WORD * (W - 1)  # bases in the last word, in [1, 16]
    L = codes2.shape[-1]
    P = L - 16 * W + 1
    p16 = windows.rolling_pack(codes2, 16)
    r16 = tbits.reverse16(windows.rolling_pack(codes2 ^ 3, 16))
    fwd = []
    for w in range(W):
        sl = p16[..., 16 * w : 16 * w + P]
        if w == W - 1 and rem < 16:
            sl = sl & (tbits.M32 ^ ((1 << (2 * (16 - rem))) - 1))
        fwd.append(sl)
    rc = []
    for w in range(W):
        if w < W - 1 or rem == 16:
            start = k - 16 * (w + 1)
            rc.append(r16[..., start : start + P])
        else:
            rc.append((r16[..., 0:P] & ((1 << (2 * rem)) - 1)) << (2 * (16 - rem)))
    return fwd, rc


def _padded(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (bad [R, L+pad] bool, codes2 [R, L+pad] int64 2-bit codes)."""
    assert codes.ndim == 2 and codes.dtype == torch.uint8
    R, L = codes.shape
    assert L >= k, "read_len must be >= k"
    pad = 16 * num_words(k) - k + 16  # lookahead for 16-base packing
    ext = torch.cat([codes, codes.new_full((R, pad), 4)], dim=1)
    return ext >= 4, (ext & 3).to(torch.int64)


def canonical_keys(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, L] uint8 codes -> (words [R·P, W] int32, valid [R·P] bool)."""
    R, L = codes.shape
    P = L - k + 1
    bad, codes2 = _padded(codes, k)
    valid = ~windows.window_any(bad[:, : P + k - 1], k)
    fwd, rc = canonical_words(codes2, k)
    fwd = [f[:, :P] for f in fwd]
    rc = [r[:, :P] for r in rc]
    use_rc = torch.zeros((R, P), dtype=torch.bool, device=codes.device)
    decided = torch.zeros_like(use_rc)
    for f, r in zip(fwd, rc):
        lt = r < f
        gt = r > f
        use_rc = use_rc | (~decided & lt)
        decided = decided | lt | gt
    words = torch.stack(
        [tbits.as_i32(torch.where(use_rc, r, f)).reshape(R * P) for f, r in zip(fwd, rc)],
        dim=1,
    )
    return words, valid.reshape(R * P)


def extract(codes: torch.Tensor, k: int, m: int, B: int) -> Extracted:
    """[R, L] uint8 codes (0..3 bases, >= 4 invalid/padding) -> Extracted."""
    assert 4 <= m <= 15 and m < k
    R, L = codes.shape
    P = L - k + 1
    words, valid = canonical_keys(codes, k)
    _, codes2 = _padded(codes, k)
    n_mpos = P + (k - m)
    norms = tbits.norm_mmers(windows.rolling_pack(codes2[:, : n_mpos + m - 1], m), m)
    sigs = windows.window_min(norms, k - m + 1)
    return Extracted(
        words=words,
        bins=tbits.hash_to_bucket(sigs, B).reshape(R * P),
        sigs=sigs.to(torch.int32).reshape(R * P),
        valid=valid,
    )
