"""Sort-based exact counting — the port of ``fastkmer_tpu.ops.count_sort``.

Key columns are int32 tensors holding uint32 bit patterns, pre-sentineled:
an invalid row is all-ones (-1) in every lane, so it sorts after every real
k-mer (sentinel-safe k, or a trailing flag lane that is 0 on valid rows).
The sort is ``torch.sort`` over order-preserving int64 keys: two uint32
lanes pack into one key, the high lane sign-biased so that signed int64
order is unsigned lane order.  Up to two lanes take one sort; more lanes
take LSD passes of stable argsort, least significant key first.  Run
totals are differences of a prefix sum read at run tails (``_mark_and_count``);
compaction is a mask plus a prefix sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.tbits import M32

# Run totals must stay < 2^31 per call (the accumulator keeps int32
# weights); accumulators force a host spill when their conservative
# instance bound reaches this (2^27 of headroom below the wrap).
WEIGHT_LIMIT = (1 << 31) - (1 << 27)

_BIAS = 1 << 31


class SortedCounts(NamedTuple):
    """Sorted unique-run view over N input slots.

    words:    [N, W] int32 sorted key words (valid first, then sentinels)
    bins:     [N] int32 bin of each row, or None
    is_uniq:  [N] bool True at the TAIL row of each distinct valid key
    counts:   [N] int32 the run's total, meaningful where is_uniq
    n_valid:  [] int64 total valid instance weight
    """

    words: torch.Tensor
    bins: torch.Tensor | None
    is_uniq: torch.Tensor
    counts: torch.Tensor
    n_valid: torch.Tensor


def _pair_key(hi: torch.Tensor, lo: torch.Tensor | None) -> torch.Tensor:
    """Order-preserving int64 key of one or two uint32 lanes (int32 bits)."""
    h = hi.to(torch.int64)
    if lo is None:
        return h & M32
    return ((h ^ _BIAS) << 32) | (lo.to(torch.int64) & M32)


def sort_columns(cols: list, values: tuple = ()) -> tuple[list, tuple]:
    """Sort rows lexicographically (unsigned) over the key columns; carry
    ``values`` along.  Returns (sorted key columns, sorted values)."""
    W = len(cols)
    pairs = [(cols[i], cols[i + 1] if i + 1 < W else None) for i in range(0, W, 2)]
    if len(pairs) == 1:
        key, order = torch.sort(_pair_key(*pairs[0]))
        if W == 1:
            scols = [key.to(torch.int32)]
        else:
            # int64 -> int32 keeps the low 32 bits
            scols = [((key >> 32) ^ _BIAS).to(torch.int32), key.to(torch.int32)]
        return scols, tuple(v[order] for v in values)
    order = None
    for hi, lo in reversed(pairs):
        key = _pair_key(hi if order is None else hi[order],
                        None if lo is None else (lo if order is None else lo[order]))
        idx = torch.sort(key, stable=True).indices
        order = idx if order is None else order[idx]
    return [c[order] for c in cols], tuple(v[order] for v in values)


def _mark_and_count(key_cols: list, svalid: torch.Tensor, sw: torch.Tensor | None = None):
    """Run totals from sorted key columns, marked at run TAILS.

    Returns (is_uniq, counts int32, n_valid).  A run's total is the
    inclusive weight prefix at its tail minus the prefix at the previous
    tail, taken over the compacted tail positions (one host sync for their
    number), so the only [N] int64 buffer is the weight prefix itself.
    The JAX version propagates run heads with a cummax instead, because
    gathers are slow on a TPU; on CUDA, torch's cummax is the slow one (a
    scan that also returns indices)."""
    N = key_cols[0].shape[0]
    dev = key_cols[0].device
    tail = torch.ones(N, dtype=torch.bool, device=dev)
    neq = tail[:-1]
    torch.ne(key_cols[0][1:], key_cols[0][:-1], out=neq)
    for c in key_cols[1:]:
        neq |= c[1:] != c[:-1]
    is_uniq = tail & svalid
    tpos = torch.nonzero(tail).squeeze(1)
    if sw is None:
        at_tail = tpos + 1  # the unweighted prefix is the row number
        n_valid = svalid.sum()
    else:
        s = torch.cumsum(sw, 0, dtype=torch.int64)
        n_valid = s[-1] if N else s.sum()
        at_tail = s[tpos]
        del s
    counts = torch.zeros(N, dtype=torch.int32, device=dev)
    counts[tpos] = torch.diff(at_tail, prepend=at_tail.new_zeros(1)).to(torch.int32)
    counts.masked_fill_(~svalid, 0)  # the sentinel run's tail
    return is_uniq, counts, n_valid


def count_presentineled(cols: list, weights: torch.Tensor | None = None) -> SortedCounts:
    """Count from pre-sentineled key columns: sort the bare keys, derive
    validity from the sentinel.  ``weights`` (int32, 0 on sentinel rows)
    turns run-length counting into weighted merging.  bins are None."""
    W = len(cols)
    swords, svals = sort_columns(list(cols), () if weights is None else (weights,))
    svalid = swords[W - 1] != -1
    is_uniq, counts, n_valid = _mark_and_count(
        swords, svalid, None if weights is None else svals[0]
    )
    return SortedCounts(
        words=torch.stack(swords, dim=1), bins=None, is_uniq=is_uniq,
        counts=counts, n_valid=n_valid,
    )


def count_sorted(
    words: torch.Tensor,
    bins: torch.Tensor | None,
    valid: torch.Tensor,
    weights: torch.Tensor | None = None,
    sentinel_safe: bool = False,
) -> SortedCounts:
    """words [N, W] int32, valid [N] bool -> SortedCounts.

    ``bins`` ([N] int32) and ``weights`` ([N] int32) are optional carried
    columns: the result's bins are None without them, and counts are plain
    run lengths without weights.  ``sentinel_safe=True`` (k % 16 != 0)
    rewrites invalid rows to the all-ones sentinel and sorts the W words
    alone; otherwise a validity flag (0 valid, 1 invalid) is a real leading
    key, so an all-T k-mer never merges with an invalid row."""
    W = words.shape[1]
    values: list = []
    if bins is not None:
        values.append(bins)
    if weights is not None:
        values.append(torch.where(valid, weights.to(torch.int32), 0))
    if sentinel_safe:
        keys = [torch.where(valid, words[:, w], -1) for w in range(W)]
        skeys, svals = sort_columns(keys, tuple(values))
        swords = skeys
        svalid = swords[W - 1] != -1
    else:
        flag = (~valid).to(torch.int32)
        keys = [flag] + [words[:, w] for w in range(W)]
        skeys, svals = sort_columns(keys, tuple(values))
        swords = skeys[1:]
        svalid = skeys[0] == 0
    del keys
    is_uniq, counts, n_valid = _mark_and_count(
        skeys, svalid, svals[-1] if weights is not None else None
    )
    return SortedCounts(
        words=torch.stack(swords, dim=1),
        bins=svals[0] if bins is not None else None,
        is_uniq=is_uniq,
        counts=counts,
        n_valid=n_valid,
    )


def bin_histogram(bins: torch.Tensor, valid: torch.Tensor, B: int) -> torch.Tensor:
    """Per-bin k-mer instance counts ([B] int32) of the valid rows."""
    return torch.bincount(
        torch.where(valid, bins, B), minlength=B + 1
    )[:B].to(torch.int32)


def compact_marked(cols: tuple, counts: torch.Tensor, is_uniq: torch.Tensor, out_cap: int):
    """Move the marked rows of a SORTED run view to the front, in order, at
    fixed capacity.

    Returns (cols_out tuple of [out_cap], counts_out [out_cap], n_u,
    overflow), the last two 0-d int64 tensors.  Rows past n_u are
    sentinel/0; marked rows beyond out_cap are dropped and counted in
    ``overflow``.  No host sync: rows are scattered to their prefix-sum
    rank, and rows that are unmarked or over capacity land in one discard
    slot."""
    dev = counts.device
    rank = torch.cumsum(is_uniq, 0) - 1
    keep = is_uniq & (rank < out_cap)
    dest = torch.where(keep, rank, out_cap)
    out = []
    for c, fill in [(c, -1) for c in cols] + [(counts, 0)]:
        o = torch.full((out_cap + 1,), fill, dtype=c.dtype, device=dev)
        o.scatter_(0, dest, c)
        out.append(o[:out_cap])
    n_u = is_uniq.sum()
    return tuple(out[:-1]), out[-1], n_u, torch.clamp(n_u - out_cap, min=0)


def sentinel_safe_for(k: int) -> bool:
    """True when the last packed word has zero pad bits (k % 16 != 0), so
    the all-ones sentinel cannot collide with any real k-mer."""
    return k % 16 != 0
