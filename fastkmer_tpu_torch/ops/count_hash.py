"""Hash-based exact counting, the ``useHT=1`` engine — the port of
``fastkmer_tpu.ops.count_hash``.

The reference's HT path (``extractKXmersHT``,
SparkBinKmerCounter.scala:664-739) counts in an open-addressing hash map.
The JAX package keeps the hash-based idea in a sort-friendly form, and the
port keeps the JAX design as torch ops:

    sort by (validity flag, fp_hi, fp_lo)   # 64-bit fingerprint of the words
    run totals over equal fingerprints      (count_sort._mark_and_count)
    verify: adjacent rows inside a run have equal words

Two distinct k-mers with one fingerprint raise ``FingerprintCollision``, so
the count stays exact.  Words travel as int32 bit patterns, as everywhere in
the port; the murmur mix runs on int64 holding unsigned 32-bit values
(``core.tbits``), because torch's uint32 has no shift or add.  Its multiplies
overflow int64 before the mask; two's-complement wraparound keeps the low 32
bits exact (as ``tbits.hash_to_bucket`` relies on too).

Rows come out in fingerprint order.  For W <= 2 words the fingerprint is the
key itself, so that is k-mer order; for W >= 3 it is not, and a caller that
needs k-mer order sorts the unique rows (``unique_in_kmer_order``).  The
speed of this engine against the sort engine on the card is in PERF.md.
"""

from __future__ import annotations

import torch

from ..core.tbits import M32, as_i32, as_u32, pair_key
from .count_sort import SortedCounts, _mark_and_count, sort_columns


class FingerprintCollision(RuntimeError):
    """Two distinct k-mers shared a 64-bit fingerprint; re-run with the
    sort engine (useHT=0)."""


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 holding unsigned 32-bit values."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def fingerprint(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, W] int32 words -> (hi, lo), the 64-bit fingerprint as two int32
    lanes holding uint32 bit patterns."""
    N, W = words.shape
    if W == 1:
        return torch.zeros(N, dtype=torch.int32, device=words.device), words[:, 0]
    if W == 2:
        return words[:, 0], words[:, 1]  # the k-mer is its own fingerprint
    hi = torch.full((N,), 0x9E3779B9, dtype=torch.int64, device=words.device)
    lo = torch.full((N,), 0x85EBCA6B, dtype=torch.int64, device=words.device)
    for w in range(W):
        x = as_u32(words[:, w])
        hi = _mix32(hi ^ ((x * 0xCC9E2D51) & M32))
        # the JAX line reads ``lo + (w+1)*C ^ x``: Python parses it as
        # ``(lo + (w+1)*C) ^ x``, with the sum wrapping at 2^32
        lo = _mix32(((lo + ((w + 1) * 0x27D4EB2F & M32)) & M32) ^ x)
    return as_i32(hi), as_i32(lo)


def count_hashed(
    words: torch.Tensor,
    bins: torch.Tensor | None,
    valid: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> tuple[SortedCounts, torch.Tensor]:
    """Like count_sort.count_sorted, keyed on 64-bit fingerprints.

    Returns (SortedCounts, collision: 0-d bool tensor).  The result's words
    are each row's own words (equal to the run head's when there is no
    collision), in fingerprint order; invalid rows sort last.  ``bins`` and
    ``weights`` are optional carried columns, as in count_sorted."""
    N, W = words.shape
    hi, lo = fingerprint(words)
    flag = (~valid).to(torch.int32)
    # stable sorts, least significant key first: the 64-bit fingerprint,
    # then the flag; the flag is never folded into the fingerprint, so a
    # valid row whose fingerprint is all ones still sorts before every
    # invalid row
    order = torch.sort(pair_key(hi, lo), stable=True).indices
    order = order[torch.sort(flag[order], stable=True).indices]
    sflag, shi, slo = flag[order], hi[order], lo[order]
    swords = words[order]
    sbins = None if bins is None else bins[order]
    sw = None if weights is None else torch.where(valid, weights.to(torch.int32), 0)[order]
    del order
    svalid = sflag == 0
    is_uniq, counts, n_valid = _mark_and_count([sflag, shi, slo], svalid, sw)
    # inside a fingerprint run every word equals the head's iff every
    # adjacent pair is equal (transitivity): a shifted compare, no gather
    same_run = (shi[1:] == shi[:-1]) & (slo[1:] == slo[:-1]) & (sflag[1:] == sflag[:-1])
    neq_words = (swords[1:] != swords[:-1]).any(dim=1)
    collision = (same_run & neq_words & svalid[1:]).any()
    return SortedCounts(words=swords, bins=sbins, is_uniq=is_uniq, counts=counts,
                        n_valid=n_valid), collision


def unique_in_kmer_order(sc: SortedCounts) -> tuple[torch.Tensor, torch.Tensor]:
    """count_hashed's unique rows -> (words [U, W] int32 in ascending k-mer
    order, counts int32 [U]).  For W <= 2 fingerprint order is k-mer order;
    wider rows are sorted by their words."""
    idx = torch.nonzero(sc.is_uniq).squeeze(1)
    words, counts = sc.words[idx], sc.counts[idx]
    if words.shape[1] <= 2:
        return words, counts
    cols, (counts,) = sort_columns(list(words.unbind(1)), (counts,))
    return torch.stack(cols, 1), counts
