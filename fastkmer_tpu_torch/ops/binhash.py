"""Recompute a k-mer's bin from its packed canonical words — the port of
``fastkmer_tpu.ops.binhash``.

The signature (minimizer) is a pure function of the k-mer string, so bins
never ride through sorts: they are recomputed once from the final unique
words.  Plain torch: the JAX package leaves this elementwise chain to XLA.
"""

from __future__ import annotations

import torch

from ..core import tbits
from ..core.bits import BASES_PER_WORD


def _mmer_at(wcols: list, m: int, j: int) -> torch.Tensor:
    """m-mer starting at base j, stitched from int64 word columns ([N])."""
    a, r = divmod(j, BASES_PER_WORD)
    v = wcols[a]
    if r:
        v = (v << (2 * r)) & tbits.M32
        if a + 1 < len(wcols) and r + m > BASES_PER_WORD:
            v = v | (wcols[a + 1] >> (32 - 2 * r))
    return v >> (2 * (BASES_PER_WORD - m))


def signatures_from_words(words: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Minimizer signature of each packed k-mer row: [N, W] int32 words
    (uint32 bit patterns) -> [N] int64."""
    wcols = [tbits.as_u32(words[:, w]) for w in range(words.shape[1])]
    sig = None
    for j in range(k - m + 1):
        nv = tbits.norm_mmers(_mmer_at(wcols, m, j), m)
        sig = nv if sig is None else torch.minimum(sig, nv)
    return sig


def bins_from_words(words: torch.Tensor, k: int, m: int, B: int) -> torch.Tensor:
    """Bin id of each packed k-mer row ([N] int32)."""
    return tbits.hash_to_bucket(signatures_from_words(words, k, m), B)
