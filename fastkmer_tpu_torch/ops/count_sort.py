"""Sort-based exact counting — the port of ``fastkmer_tpu.ops.count_sort``.

Key columns are int32 tensors holding uint32 bit patterns, pre-sentineled:
an invalid row is all-ones (-1) in every lane, so it sorts after every real
k-mer (sentinel-safe k, or a trailing flag lane that is 0 on valid rows).
The sort is ``torch.sort`` over order-preserving int64 keys: two uint32
lanes pack into one key, the high lane sign-biased so that signed int64
order is unsigned lane order.  Up to two lanes take one sort; more lanes
take LSD passes of stable argsort, least significant key first.  Run
totals are differences of a prefix sum read at run tails (``_mark_and_count``);
compaction is a mask plus a prefix sum, or, under FASTKMER_PALLAS_COMPACT=1,
the JAX package's block-sort route through kernel C (``ops.cuda_sort``).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core.tbits import BIAS, pair_key
from . import cuda_sort

# Run totals must stay < 2^31 per call (the accumulator keeps int32
# weights); accumulators force a host spill when their conservative
# instance bound reaches this (2^27 of headroom below the wrap).
WEIGHT_LIMIT = (1 << 31) - (1 << 27)


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


def sort_columns(cols: list, values: tuple = ()) -> tuple[list, tuple]:
    """Sort rows lexicographically (unsigned) over the key columns; carry
    ``values`` along.  Returns (sorted key columns, sorted values)."""
    W = len(cols)
    pairs = [(cols[i], cols[i + 1] if i + 1 < W else None) for i in range(0, W, 2)]
    if len(pairs) == 1:
        key, order = torch.sort(pair_key(*pairs[0]))
        if W == 1:
            scols = [key.to(torch.int32)]
        else:
            # int64 -> int32 keeps the low 32 bits
            scols = [((key >> 32) ^ BIAS).to(torch.int32), key.to(torch.int32)]
        return scols, tuple(v[order] for v in values)
    order = None
    for hi, lo in reversed(pairs):
        key = pair_key(hi if order is None else hi[order],
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


def compact_marked(cols: tuple, counts: torch.Tensor, is_uniq: torch.Tensor, out_cap: int,
                   block: int = 8192, block_sort: bool = False):
    """Move the marked rows of a SORTED run view to the front, in order, at
    fixed capacity.

    Returns (cols_out tuple of [out_cap], counts_out [out_cap], n_u,
    overflow), the last two 0-d int64 tensors.  Rows past n_u are
    sentinel/0; marked rows beyond out_cap are dropped and counted in
    ``overflow``.  No host sync.

    By default rows are scattered to their prefix-sum rank, and rows that
    are unmarked or over capacity land in one discard slot.  ``block_sort``
    takes the JAX package's route instead (its ``pallas=True``): unmarked
    rows become the all-ones sentinel with count 0, each ``block`` of rows
    is sorted by ``cuda_sort.sort_blocks`` (the kernel on CUDA, its plain
    version on the CPU), which moves a block's live rows to its front in
    order, and the blocks' live prefixes are scattered to their clipped
    prefix-sum offsets.  The rows are padded with sentinel rows of count 0
    to a block multiple, and ``block`` shrinks to the power of two >= N
    (at least 1024) for a short input.  Both routes give the same result;
    the sentinel must sort after every live row (sentinel-safe keys, or a
    trailing lane never all-ones on live rows)."""
    if block_sort:
        return _compact_blocks(cols, counts, is_uniq, out_cap, block)
    rank = torch.cumsum(is_uniq, 0) - 1
    dest = torch.where(is_uniq & (rank < out_cap), rank, out_cap)
    return _place(tuple(cols) + (counts,), dest, out_cap, is_uniq.sum())


def _place(lanes: tuple, dest: torch.Tensor, out_cap: int, n_u: torch.Tensor):
    """Scatter key lanes + the count lane to ``dest`` (out_cap: discard)
    in sentinel/0-filled [out_cap] outputs -> compact_marked's tuple."""
    out = []
    for i, c in enumerate(lanes):
        o = torch.full((out_cap + 1,), -1 if i < len(lanes) - 1 else 0, dtype=c.dtype,
                       device=c.device)
        o.scatter_(0, dest, c)
        out.append(o[:out_cap])
    return tuple(out[:-1]), out[-1], n_u, torch.clamp(n_u - out_cap, min=0)


def _compact_blocks(cols: tuple, counts: torch.Tensor, is_uniq: torch.Tensor, out_cap: int,
                    block: int):
    """compact_marked's block-sort route (JAX count_sort.py:265-321)."""
    N = counts.shape[0]
    W = len(cols)
    dev = counts.device
    block = min(block, max(cuda_sort.MIN_BLOCK, 1 << max(N - 1, 0).bit_length()))
    pad = -N % block
    # one [W + 1, N + pad] buffer: unmarked and padding rows are the
    # sentinel with count 0; the block sort runs on it in place
    buf = torch.full((W + 1, N + pad), -1, dtype=torch.int32, device=dev)
    dead = ~is_uniq
    for i, c in enumerate(cols):
        buf[i, :N].copy_(c).masked_fill_(dead, -1)
    buf[W, :N].copy_(counts).masked_fill_(dead, 0)
    buf[W, N:] = 0
    del dead
    blocked = cuda_sort.sort_blocks_(buf, W, block)
    nb = (N + pad) // block
    live = (blocked[W - 1] != -1).view(nb, block)
    h = live.sum(1)
    off = torch.clamp(torch.cumsum(h, 0) - h, max=out_cap)
    pos = off[:, None] + torch.arange(block, device=dev)[None, :]
    dest = torch.where(live & (pos < out_cap), pos, out_cap).view(-1)
    del live, pos
    return _place(blocked, dest, out_cap, h.sum())


def block_sort_opt_in() -> bool:
    """FASTKMER_PALLAS_COMPACT=1 routes compact_marked's compaction through
    the block sort, as it routes the JAX package's through its Pallas
    kernel (``fastkmer_tpu.ops.count_sort.pallas_compact_opt_in``): the
    same environment means the same thing to both packages.  In this
    package it selects the CUDA block sort kernel (ops.cuda_sort).  Off by
    default."""
    return os.environ.get("FASTKMER_PALLAS_COMPACT") == "1"


def sentinel_safe_for(k: int) -> bool:
    """True when the last packed word has zero pad bits (k % 16 != 0), so
    the all-ones sentinel cannot collide with any real k-mer."""
    return k % 16 != 0
