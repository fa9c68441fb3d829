"""Job orchestration on torch — the port of ``fastkmer_tpu.pipeline``'s
single-chip count job (``execute_job``) and its repair:

    host ingest -> fixed-shape [R, L] code batches           (shared, host)
      -> stage-1 extract, the CUDA kernel (ops.cuda_extract) (device)
      -> sort engine: DeviceAccumulator fan-in weighted merge (device)
         of raw or pre-deduplicated parts (PreDedupController)
         HT engine (useHT=1): per-batch fingerprint count     (device)
      -> finalize: bins recomputed from words, host merge    (device -> host)
      -> per-bin text or npz output + manifest               (shared, host)

Every device function takes its tensors on an explicit ``device``.  On a
CUDA device the extract always runs as the kernel; on the CPU it runs the
kernel's plain version.  ``checkpoint_dir`` makes a job resumable
(output.manifest.BatchCheckpointer), ``keep_table`` keeps the table beside
the output for ``repair_output``.  Outputs are byte-identical to the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, NamedTuple

import numpy as np
import torch

from .config import JobConfig
from .core.bits import empty_table, num_words
from .ingest import batch as batching
from .ingest.prefetch import prefetched
from .ops import binhash, count_hash, count_sort, cuda_extract
from .output import manifest as manifest_mod
from .output import writer
from .utils.timing import StageTimer, fenced_span, maybe_profile


class CountResult(NamedTuple):
    words: np.ndarray  # [U, W] uint32 unique canonical k-mers, ascending
    counts: np.ndarray  # [U] int64
    bins: np.ndarray  # [U] int32
    n_instances: int  # total counted k-mer instances
    n_bases: int
    n_reads: int
    n_batches: int  # code batches streamed through the device
    timings: dict  # seconds a span name (StageTimer.as_dict)
    spans: list  # StageTimer.records
    counters: dict  # StageTimer.counters


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and absent
    (a CUDA run never carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    return dev


def table_to_device(words: np.ndarray, counts: np.ndarray, bins: np.ndarray, device):
    """Host table (words [U, W] uint32, counts int64, bins int32) -> (word
    columns tuple of int32 [U], counts int64 [U], bins int32 [U]) on device."""
    w = torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32))
    w = w.to(device).t().contiguous()
    return (
        tuple(w.unbind(0)),
        torch.from_numpy(np.asarray(counts, np.int64)).to(device),
        torch.from_numpy(np.asarray(bins, np.int32)).to(device),
    )


def table_to_host(cols, counts: torch.Tensor, bins: torch.Tensor,
                  timer: StageTimer | None = None):
    """Inverse of table_to_device: ``cols`` is a tuple of int32 [U] columns
    or one [U, W] int32 tensor.  ``timer`` counts the bytes brought to the
    host in ``d2h_bytes``."""
    words = cols if isinstance(cols, torch.Tensor) else torch.stack(tuple(cols), 1)
    if timer is not None:
        timer.count("d2h_bytes", sum(t.nbytes for t in (words, counts, bins)))
    return (
        words.cpu().numpy().view(np.uint32),
        counts.cpu().numpy().astype(np.int64),
        bins.cpu().numpy().astype(np.int32),
    )


def _batch_extract_keys(codes: torch.Tensor, k: int, m: int, B: int, flagged: bool = False):
    """Stage 1 only: pre-sentineled sort-key columns (+ the constant-zero
    flag lane for k % 16 == 0, where the bare all-ones sentinel equals an
    all-T k-mer).  No per-batch sort: the accumulator's fan-in merge does
    all the sorting."""
    return cuda_extract.extract_sentinel(codes, k, m, B, flag_lane=flagged)


def _batch_count_sorted(codes: torch.Tensor, k: int, m: int, B: int) -> count_sort.SortedCounts:
    """Per-batch count to a sorted unique-run view without bins: kernel A
    (its plain version on the CPU), then ``count_presentineled``.  The
    counterpart of the JAX ``_batch_count_pallas(..., with_bins=False)``;
    at k % 16 == 0 the words carry the flag lane (0 on valid rows)."""
    cols = _batch_extract_keys(codes, k, m, B, not count_sort.sentinel_safe_for(k))
    return count_sort.count_presentineled(list(cols))


def _batch_count(codes: torch.Tensor, k: int, m: int, B: int, timer: StageTimer):
    """Per-batch count straight to a host unique table (the path without
    the accumulator)."""
    W = num_words(k)
    sc = _batch_count_sorted(codes, k, m, B)
    idx = torch.nonzero(sc.is_uniq).squeeze(1)
    words = sc.words[idx, :W]
    return table_to_host(words, sc.counts[idx], binhash.bins_from_words(words, k, m, B),
                         timer)


def _batch_count_ht(codes: torch.Tensor, coll: torch.Tensor, k: int, m: int, B: int):
    """HT-engine step (useHT=1): the count-mode extract (the kernel on CUDA),
    then fingerprint-keyed counting.  -> ((words [U, W] int32 in ascending
    k-mer order, counts int32 [U], bins int32 [U]) on the device, coll |
    this batch's collision flag).  The flag stays on the device and is read
    once after the loop; bins come from the run-head words."""
    W = num_words(k)
    flagged = not count_sort.sentinel_safe_for(k)
    cols = cuda_extract.extract_sentinel(codes, k, m, B, flag_lane=flagged)
    # validity from the flag lane (0 on valid rows) or the all-ones sentinel
    valid = cols[W] == 0 if flagged else cols[W - 1] != -1
    sc, batch_coll = count_hash.count_hashed(torch.stack(cols[:W], 1), None, valid)
    del cols, valid
    words, counts = count_hash.unique_in_kmer_order(sc)
    return (words, counts, binhash.bins_from_words(words, k, m, B)), coll | batch_coll


def _dedup_cap(npos: int) -> int:
    """The dedup step's compaction capacity for a batch of ``npos``
    windows: npos / 4, npos rounded up to a 64Ki granule."""
    return (npos + (-npos % (1 << 16))) // 4


def _batch_count_dedup(codes: torch.Tensor, k: int, m: int, B: int, cap: int):
    """Pre-dedup step for duplication-heavy inputs: count the batch and
    compact its unique rows to ``cap``.  Returns (ccols, wts, n_u, over,
    raw_cols): the batch's distinct count and compaction overflow as 0-d
    tensors, plus the pre-sort key columns, which the caller admits instead
    when ``over`` is nonzero (lossless)."""
    cols = _batch_extract_keys(codes, k, m, B)
    sc = count_sort.count_presentineled(list(cols))
    ccols, wts, n_u, over = count_sort.compact_marked(
        tuple(sc.words.unbind(1)), sc.counts, sc.is_uniq, cap,
        block_sort=count_sort.block_sort_opt_in(),
    )
    return ccols, wts, n_u, over, cols


def _to_merge_rows(sc: count_sort.SortedCounts):
    """SortedCounts -> (key cols, weights) in merge-row form: unique rows
    keep their words and total count, every other row becomes the
    sentinel with weight 0."""
    cols = tuple(torch.where(sc.is_uniq, sc.words[:, w], -1) for w in range(sc.words.shape[1]))
    return cols, torch.where(sc.is_uniq, sc.counts, 0)


def _init_acc_state(acc_cap: int, lanes: int, device: torch.device):
    cols = tuple(torch.full((acc_cap,), -1, dtype=torch.int32, device=device)
                 for _ in range(lanes))
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return (cols, torch.zeros(acc_cap, dtype=torch.int32, device=device), zero, zero)


def _acc_merge(parts: list, acc, block_sort: bool = False):
    """One weighted merge: (raw or counted parts, accumulator) -> new
    accumulator at fixed capacity.  ``block_sort`` compacts through the
    block sort (count_sort.compact_marked, 32768-row blocks).

    parts: list of (cols tuple, wts | None); None means raw instances
    (weight 1 where not sentinel).  The list is emptied once its parts are
    concatenated, so their buffers are freed before the sort.
    acc: (cols, wts, n_unique, overflow)."""
    acc_cols, acc_wts, _, acc_over = acc
    W = len(acc_cols)
    acc_cap = acc_cols[0].shape[0]
    mcols = [torch.cat([p[0][w] for p in parts] + [acc_cols[w]]) for w in range(W)]
    wts = torch.cat(
        [(c[W - 1] != -1).to(torch.int32) if wt is None else wt for c, wt in parts]
        + [acc_wts]
    )
    parts.clear()
    sc = count_sort.count_presentineled(mcols, weights=wts)
    del mcols, wts
    new_cols, new_wts, n_u, over = count_sort.compact_marked(
        tuple(sc.words.unbind(1)), sc.counts, sc.is_uniq, acc_cap,
        block=1 << 15, block_sort=block_sort,
    )
    return (new_cols, new_wts, torch.clamp(n_u, max=acc_cap), acc_over + over)


class DeviceAccumulator:
    """Device-resident cross-batch merging with deferred sorting.

    Buffers RAW pre-sentineled key columns per batch (``add_raw``: no
    per-batch sort), merges every ``fanin`` parts with ONE weighted count
    sort + compaction into a fixed-capacity unique table, and spills the
    table to the host (``host_spills``: numpy (words, counts, bins)
    triples) when the distinct count outgrows ``acc_cap``.  ``timer``
    counts each move of the table to the host, the last one at finalize
    included, in ``spills``, and its bytes in ``d2h_bytes``.

    A merge window holds parts of one kind, raw (``add_raw``) or weighted
    (``add_part``): a part of the other kind merges the pending ones before
    its own checks.  ``check`` merges them and reads the table's counters.

    Capacity pressure is tracked with conservative host-side upper bounds;
    an exact (blocking) scalar read happens only when a spill decision
    needs it.  ``unique_ub`` — a caller-asserted bound on total distinct
    keys — sizes the table once and disables the room checks; the device
    overflow counter still raises at finalize if the bound was wrong.
    """

    # pending-buffer device-memory budget behind the max_device_rows
    # default: 192M buffered rows at W=2 (k <= 32), fewer rows for wider keys
    PENDING_BYTE_BUDGET = 1_536_000_000

    def __init__(
        self,
        k: int,
        fanin: int = 16,
        max_device_rows: int | None = None,
        m: int = 10,
        B: int = 512,
        acc_cap: int | None = None,
        unique_ub: int | None = None,
        extra_lanes: int = 0,
        device="cuda",
        timer: StageTimer | None = None,
    ):
        self.k = k
        self.W = num_words(k)  # k-mer key words (the binhash input)
        # extra trailing key lanes ride every merge; valid rows never carry
        # all-ones in them, so the sentinel stays collision-free for any k
        self.lanes = self.W + extra_lanes
        self.m = m
        self.B = B
        self.fanin = fanin
        self.device = resolve_device(device)
        self.block_sort = count_sort.block_sort_opt_in()  # read once, as JAX does
        if max_device_rows is None:
            max_device_rows = self.PENDING_BYTE_BUDGET // (4 * self.lanes)
        self.max_device_rows = max_device_rows
        if unique_ub is not None and acc_cap is None:
            # next 64Ki granule + 2 granules of slack, floor 2^14
            acc_cap = max(1 << 14, (-(-int(unique_ub) // (1 << 16)) + 2) * (1 << 16))
        self.acc_cap = acc_cap  # sized from the first part when None
        self.assume_fits = unique_ub is not None
        self.state = None  # (cols tuple [acc_cap], wts, n_unique [], overflow [])
        self.pending: list = []  # (cols tuple, wts | None)
        self.rows = 0  # pending buffered rows
        self._acc_ub = 0  # conservative bound on accumulated uniques
        self._pend_ub = 0  # conservative bound on pending new uniques
        self._wt_dev = 0  # bound on total instance weight on device
        self.host_spills: list = []  # (words, counts, bins) numpy triples
        self.timer = timer or StageTimer()

    def _init_state(self):
        return _init_acc_state(self.acc_cap, self.lanes, self.device)

    def add_raw(self, cols: tuple) -> None:
        """Buffer one batch of pre-sentineled key columns (weight 1 each)."""
        if self.pending and self.pending[-1][1] is not None:  # close a window of weighted parts
            self._merge_pending()
        n = int(cols[0].shape[0])
        self._append((tuple(cols), None), n, n)

    def add(self, sc: count_sort.SortedCounts) -> None:
        """Buffer one pre-counted batch (e.g. _batch_count_sorted's):
        unique rows weighted by their count.  At k % 16 == 0 the words
        carry the flag lane, so the accumulator needs extra_lanes=1, as
        for add_raw.  Bounded by its weight total, as add_part is."""
        cols, wts = _to_merge_rows(sc)
        if len(cols) != self.lanes:
            raise ValueError(f"{len(cols)} key lanes for an accumulator of {self.lanes}")
        self.add_part(cols, wts)

    def add_part(self, cols: tuple, wts: torch.Tensor) -> None:
        """Buffer one pre-counted part: key columns with weights (0 on
        sentinel rows), e.g. _batch_count_dedup output or a host table
        from table_to_device.  The part's weight total (one device read)
        bounds the device weight; the JAX version uses its row count,
        which undercounts a compacted part."""
        if self.pending and self.pending[-1][1] is None:  # close a window of raw parts
            self._merge_pending()
        weight = int(wts.sum())
        if weight > count_sort.WEIGHT_LIMIT:
            raise ValueError(f"part weight {weight} exceeds WEIGHT_LIMIT")
        self._append((tuple(cols), wts.to(torch.int32)), int(wts.shape[0]), weight)

    def _append(self, part, n_new_ub: int, weight: int) -> None:
        if self.acc_cap is None:
            self.acc_cap = 1 << max(14, (2 * n_new_ub - 1).bit_length())
        if self.state is None:
            self.state = self._init_state()
        if self._wt_dev + weight > count_sort.WEIGHT_LIMIT:
            # int32 count wrap guard: bounds weights, not capacity, so it
            # applies under assume_fits too
            self.spill()
        self._ensure_room(n_new_ub)
        self.pending.append(part)
        self.rows += int(part[0][0].shape[0])
        self._pend_ub += n_new_ub
        self._wt_dev += weight
        if len(self.pending) >= self.fanin or self.rows > self.max_device_rows:
            self._merge_pending()

    def _merge_pending(self) -> None:
        if not self.pending:
            return
        parts, self.pending = self.pending, []
        self.state = _acc_merge(parts, self.state, self.block_sort)
        self.rows = 0
        self._acc_ub = min(self._acc_ub + self._pend_ub, self.acc_cap)
        self._pend_ub = 0

    def _ensure_room(self, incoming: int) -> None:
        if self.assume_fits:
            return  # caller asserted total uniques <= acc_cap; finalize verifies
        if self._acc_ub + self._pend_ub + incoming <= self.acc_cap:
            return
        stats = self._stats()  # exact occupancy before deciding to spill
        self._acc_ub = stats["n_unique"]
        while self._acc_ub + self._pend_ub + incoming > self.acc_cap:
            if self.pending:
                # merge first: duplicates may collapse the pending bound
                stats = self.check()
                self._acc_ub = stats["n_unique"]
            elif self._acc_ub > 0:
                self._raise_if_lost(stats)
                self._spill(stats)
            else:
                # a single part exceeds acc_cap: the device overflow
                # counter records the loss and finalize raises
                break

    def _stats(self) -> dict:
        if self.state is None:
            return {"n_unique": 0, "overflow": 0}
        n_u, over = torch.stack(self.state[2:]).tolist()
        return {"n_unique": n_u, "overflow": over}

    def check(self) -> dict:
        """Merge the pending parts into the table, then return its counters
        ``n_unique`` and ``overflow`` (one device read), as
        ``DistributedCounter.check`` does."""
        self._merge_pending()
        return self._stats()

    def _raise_if_lost(self, stats: dict) -> None:
        if stats["overflow"]:
            raise RuntimeError(
                f"accumulator overflow: {stats['overflow']} uniques lost; "
                f"raise acc_cap (= {self.acc_cap})"
            )

    def _spill(self, stats: dict) -> None:
        """Move the accumulated table to host_spills and start a new one."""
        n_u = stats["n_unique"]
        if n_u:
            cols, wts, _, _ = self.state
            words = torch.stack([c[:n_u] for c in cols], 1)
            bins = binhash.bins_from_words(words[:, : self.W], self.k, self.m, self.B)
            self.host_spills.append(table_to_host(words, wts[:n_u], bins, self.timer))
            self.timer.count("spills")
        self.state = self._init_state()
        self._acc_ub = 0
        self._wt_dev = 0  # spilled weights left the device (pending is empty)

    def spill(self) -> None:
        """Merge the pending parts and move the table to ``host_spills``
        (a checkpoint persists them); raises if a unique was lost."""
        stats = self.check()
        self._raise_if_lost(stats)
        self._spill(stats)

    def finalize(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (unique words [U, lanes] ascending, counts [U], bins [U]) on host."""
        self.spill()
        if len(self.host_spills) == 1:
            return self.host_spills[0]
        return merge_partials(self.host_spills, self.lanes)


def merge_partials(
    parts: list[tuple[np.ndarray, np.ndarray, np.ndarray]], W: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host merge of unique sorted (words, counts, bins) tables: the native
    k-way heap merge (``output.native``) when it is built, else
    numpy lexsort + reduceat.  No parts give the empty table."""
    if not parts:
        return empty_table(W)
    if len(parts) > 1:
        from .output import native as out_native

        merged = out_native.merge_sorted_parts(parts, W)
        if merged is not None:
            return merged
    words = np.concatenate([p[0] for p in parts], axis=0)
    counts = np.concatenate([p[1] for p in parts], axis=0)
    bins = np.concatenate([p[2] for p in parts], axis=0)
    if words.shape[0] == 0:
        return words, counts, bins
    order = np.lexsort(tuple(words[:, w] for w in reversed(range(W))))
    ws, cs, bs = words[order], counts[order], bins[order]
    new = np.empty(ws.shape[0], dtype=bool)
    new[0] = True
    np.any(ws[1:] != ws[:-1], axis=1, out=new[1:])
    starts = np.flatnonzero(new)
    return ws[starts], np.add.reduceat(cs, starts), bs[starts]


class QueuedPart(NamedTuple):
    """A dedup step's result waiting in ``PreDedupController.queue``."""

    batch_idx: int
    npos: int  # the batch's windows: the distinct ratio's denominator
    cols: tuple  # the compacted part's key columns
    wts: torch.Tensor  # its weights
    n_unique: torch.Tensor  # 0-d: the batch's distinct count
    overflow: torch.Tensor  # 0-d: nonzero when the compaction dropped uniques
    raw_cols: tuple  # the batch's key columns, admitted instead on overflow


class PreDedupController:
    """Which batches of the single device run the pre-dedup step
    (``_batch_count_dedup``), and when its parts reach the accumulator.

    ``prededup`` True or False forces the mode.  None is adaptive: while
    the mode is off, every PROBE_EVERY-th batch runs the step as a probe;
    each admitted part's distinct ratio turns the mode on (below
    ENGAGE_BELOW) or off.  A step's result is admitted DEDUP_LAG batches
    later, so mode flips and merge windows are a function of the input.
    A part whose compaction overflowed is admitted as the batch's raw
    columns instead (lossless) and turns adaptive mode off."""

    PROBE_EVERY = 16
    ENGAGE_BELOW = 0.24
    DEDUP_LAG = 3

    def __init__(self, acc: DeviceAccumulator, prededup: bool | None, timer: StageTimer):
        self.acc = acc
        self.timer = timer
        self.adaptive = prededup is None
        self.engaged = prededup is True
        self.queue: list[QueuedPart] = []

    def runs_dedup(self, batch_idx: int) -> bool:
        return self.engaged or (self.adaptive and batch_idx % self.PROBE_EVERY == 0)

    def push(self, batch_idx: int, npos: int, step: tuple) -> None:
        """Queue batch ``batch_idx``'s ``_batch_count_dedup`` result."""
        self.queue.append(QueuedPart(batch_idx, npos, *step))

    def admit_due(self, batch_idx: int) -> None:
        """Admit the queued parts of the batches DEDUP_LAG or more before
        ``batch_idx``: their decisions steer this batch's step."""
        while self.queue and self.queue[0].batch_idx <= batch_idx - self.DEDUP_LAG:
            self._admit(self.queue.pop(0))

    def drain(self) -> None:
        """Admit every queued part: before a checkpoint, whose cursor
        claims the batches, and before finalize."""
        while self.queue:
            self._admit(self.queue.pop(0))

    def _admit(self, q: QueuedPart) -> None:
        if int(q.overflow):
            self.timer.count("dedup_overflows")
            self.acc.add_raw(q.raw_cols)
            self.timer.count("raw_parts")
            if self.adaptive:
                self.engaged = False
            return
        self.acc.add_part(q.cols, q.wts)
        self.timer.count("dedup_parts")
        if self.adaptive:
            self.engaged = int(q.n_unique) / max(q.npos, 1) < self.ENGAGE_BELOW


def count_batches(
    batches: Iterable[tuple[np.ndarray, int, int]],
    k: int,
    m: int,
    B: int,
    timer: StageTimer | None = None,
    device="cuda",
    device_accumulate: bool | None = None,
    unique_ub: int | None = None,
    prededup: bool | None = None,
    engine: str = "sort",
    checkpointer: manifest_mod.BatchCheckpointer | None = None,
) -> CountResult:
    """Stream code batches through the device and return the merged table.

    ``engine`` is "sort" (useHT=0) or "hash" (useHT=1: per-batch
    fingerprint counts, merged on the host).  ``device_accumulate``
    defaults to True for the sort engine on CUDA (and whenever
    ``unique_ub`` or a forced ``prededup`` asks for the accumulator).
    Three routes: the HT engine and the host path (``device_accumulate``
    off) bring each batch's table to the host and merge them there; the
    accumulator route feeds a ``DeviceAccumulator``, whose merge windows
    each hold one kind of part.  ``prededup`` steers its
    ``PreDedupController``: None (default) is adaptive, True/False force
    the per-batch count + compaction on or off.

    ``batches`` yield (codes, n_reads, n_bases), codes a numpy array or a
    tensor (moved to ``device``).
    ``checkpointer`` resumes from its cursor (the covered batches are read
    and skipped) and checkpoints every ``checkpointer.interval`` batches:
    the accumulator by a forced spill, the host path per batch.
    """
    dev = resolve_device(device)
    timer = timer or StageTimer()
    W = num_words(k)
    if unique_ub is not None and engine != "sort":
        # the HT engine's per-batch loop has no host-side room checks for
        # the assertion to elide: asserting it is a caller error
        raise NotImplementedError(
            "unique_ub (sync-free accumulator feed) is a sort-engine "
            "feature; the HT engine has no per-batch sync to skip"
        )
    if prededup is True and engine != "sort":
        raise NotImplementedError(
            "prededup (per-batch count+compact) feeds the sort-engine "
            "accumulator; the HT engine already counts per batch"
        )
    if device_accumulate is None:
        device_accumulate = engine == "sort" and (
            unique_ub is not None or prededup is True or dev.type == "cuda"
        )
    device_accumulate = device_accumulate and engine == "sort"
    # k % 16 == 0: the bare sentinel is ambiguous; the flag lane restores it
    flagged = device_accumulate and not count_sort.sentinel_safe_for(k)
    if flagged and prededup is True:
        # the dedup step is W-lane shaped: adaptive stays raw, a forced
        # prededup is an error (never silently dropped)
        raise NotImplementedError(
            "single-chip prededup does not cover k % 16 == 0 (the "
            "flagged-lane extraction); use adaptive"
        )
    acc = feed = None
    if device_accumulate:
        acc = DeviceAccumulator(k, m=m, B=B, unique_ub=unique_ub,
                                extra_lanes=1 if flagged else 0, device=dev, timer=timer)
        feed = PreDedupController(acc, False if flagged else prededup, timer)
    parts = []  # the host tables of the HT engine and the host path
    skip = 0
    if checkpointer is not None:
        # resume: the persisted parts re-enter the final merge, and the
        # batches they cover are skipped below
        skip = checkpointer.completed_batches()
        (acc.host_spills if acc is not None else parts).extend(checkpointer.load_parts())
    coll = torch.zeros((), dtype=torch.bool, device=dev) if engine == "hash" else None
    n_reads = n_bases = 0
    it = iter(batches)
    batch_idx = -1
    while True:
        with timer.span("ingest_wait"):
            item = next(it, None)
        if item is None:
            break
        codes, nr, nb = item
        batch_idx += 1
        n_reads += nr
        n_bases += nb
        if batch_idx < skip:  # counted before the interruption
            continue
        if feed is not None and feed.queue:
            with fenced_span(timer, "device_merge", dev):
                feed.admit_due(batch_idx)
        dedup = feed is not None and feed.runs_dedup(batch_idx)
        with fenced_span(timer, "device_count", dev):
            codes_t = codes if isinstance(codes, torch.Tensor) else torch.from_numpy(codes)
            if codes_t.device.type == "cpu":
                timer.count("h2d_bytes", codes_t.nbytes)
            codes_t = codes_t.to(dev)
            if engine == "hash":
                dpart, coll = _batch_count_ht(codes_t, coll, k, m, B)
            elif acc is None:
                part = _batch_count(codes_t, k, m, B, timer)
            elif dedup:
                npos = codes.shape[0] * (codes.shape[1] - k + 1)
                step = _batch_count_dedup(codes_t, k, m, B, _dedup_cap(npos))
            else:
                cols = _batch_extract_keys(codes_t, k, m, B, flagged)
        if acc is None:
            with timer.span("host_compact"):
                if engine == "hash":
                    part = table_to_host(*dpart, timer)
                    del dpart
                parts.append(part)
                if checkpointer is not None:
                    checkpointer.save_batch(batch_idx, *part)
            continue
        with fenced_span(timer, "device_merge", dev):
            if dedup:
                feed.push(batch_idx, npos, step)
            else:
                acc.add_raw(cols)
                timer.count("raw_parts")
        if checkpointer is not None and (batch_idx + 1) % checkpointer.interval == 0:
            with fenced_span(timer, "checkpoint", dev):
                # the cursor claims every batch <= batch_idx is in the
                # persisted spills, so the queued dedup parts (and an
                # overflowed part's raw columns) are admitted first
                feed.drain()
                acc.spill()
                checkpointer.save_spills(batch_idx + 1, acc.host_spills)
    if coll is not None and bool(coll):  # the run's one read of the flag
        raise count_hash.FingerprintCollision(
            "64-bit fingerprint collision; re-run with the sort engine"
        )
    with fenced_span(timer, "device_merge", dev):
        if feed is not None:
            feed.drain()  # the queued dedup parts reach the table before finalize
    with fenced_span(timer, "merge", dev):
        if acc is None:
            words, counts, bins = merge_partials(parts, W)
        else:
            words, counts, bins = acc.finalize()
            if flagged:
                words = words[:, :W]  # drop the constant flag lane
    return CountResult(
        words, counts, bins, int(counts.sum()), n_bases, n_reads, batch_idx + 1,
        timer.as_dict(), timer.records(), timer.counters(),
    )


def execute_job(
    cfg: JobConfig,
    verbose: bool = True,
    checkpoint_dir: str | None = None,
    trace_dir: str | None = None,
    keep_table: bool = False,
    unique_ub: int | None = None,
    prededup: bool | None = None,
    device="cuda",
    checkpoint_interval: int = 32,
) -> CountResult:
    """Count k-mers in cfg.dataset and (when cfg.write) write per-bin text
    files, or counts.npz for ``use_kryo_serializer``, plus the manifest.

    ``cfg.use_ht`` selects the HT engine; both engines give the same table,
    and HT text bins carry no ``EOF`` line (the reference's HT writer).
    ``checkpoint_dir`` makes the run resumable: a rerun with the same
    directory skips the batches it covers; it is emptied when the run
    completes.  ``checkpoint_interval``: batches between checkpoints.
    ``trace_dir`` wraps the count in a torch.profiler trace.
    ``keep_table`` also writes table.npz beside the output, so that
    ``repair_output`` rewrites damaged files without recounting.
    ``unique_ub``: caller-asserted bound on distinct k-mers (e.g. genome
    length) for the sync-free accumulator feed; verified at finalize.
    The result's ``spans`` and ``counters`` are the job's StageTimer
    records and counters; the root span ``job`` holds the whole call."""
    dev = resolve_device(device)
    timer = StageTimer()
    with timer.span("job"):
        if verbose:
            print(cfg.describe())
        ckpt = (
            manifest_mod.BatchCheckpointer(checkpoint_dir, checkpoint_interval)
            if checkpoint_dir
            else None
        )
        batches = prefetched(
            batching.batch_file(
                cfg.dataset, cfg.sequence_type, cfg.k, cfg.reads_per_batch, cfg.read_len,
                timer=timer,
            ),
            timer=timer,
        )
        with maybe_profile(trace_dir):
            res = count_batches(
                batches, cfg.k, cfg.m, cfg.b, timer, device=dev,
                unique_ub=unique_ub, prededup=prededup,
                engine="hash" if cfg.use_ht else "sort", checkpointer=ckpt,
            )
        if cfg.write:
            with timer.span("write_output"):
                write_output(cfg, res.words, res.counts, res.bins, keep_table=keep_table,
                             timer=timer, device=dev)
        if ckpt is not None:
            ckpt.clear()  # the run completed; its checkpoints are spent
    return res._replace(timings=timer.as_dict(), spans=timer.records(),
                        counters=timer.counters())


def write_output(cfg: JobConfig, words: np.ndarray, counts: np.ndarray, bins: np.ndarray,
                 keep_table: bool = False, timer: StageTimer | None = None,
                 device=None) -> None:
    """Per-bin text files (with the EOF sentinel for the sort engine), or
    counts.npz for ``use_kryo_serializer`` (deflated on the card when
    ``device`` is a CUDA device), plus the manifest, into cfg.output_dir;
    ``keep_table`` adds the table.npz sidecar.  ``timer`` gets the spans
    ``write_data`` (the files), ``write_sha256`` (the npz's hash) and
    ``write_manifest``."""
    timer = timer or StageTimer()
    if cfg.use_kryo_serializer:
        writer.write_binary_with_manifest(
            cfg.output_dir, dataclasses_dict(cfg), words, counts, bins, cfg.k, timer=timer,
            device=device,
        )
    else:
        with timer.span("write_data"):
            bin_hashes = writer.write_bin_files(
                cfg.output_dir, words, counts, bins, cfg.k, eof_sentinel=not cfg.use_ht,
                timer=timer,
            )
        with timer.span("write_manifest"):
            manifest_mod.write_manifest(
                cfg.output_dir, dataclasses_dict(cfg), words, counts, bins,
                bin_hashes=bin_hashes,
            )
    if keep_table:
        manifest_mod.write_table_sidecar(cfg.output_dir, words, counts, bins)


def dataclasses_dict(cfg: JobConfig) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items() if not callable(v)}


def dataclasses_replace(cfg: JobConfig, **kw) -> JobConfig:
    return dataclasses.replace(cfg, **kw)


def config_from_manifest(cfg_dict: dict) -> JobConfig:
    """The config a manifest records (``dataclasses_dict`` of the run's
    config): a MultiseqConfig for a multiseq run (its ``distance_measure``
    field), else a JobConfig."""
    if "distance_measure" in cfg_dict:
        from .multiseq.pipeline import MultiseqConfig

        return MultiseqConfig(**cfg_dict)
    return JobConfig(**cfg_dict)



def repair_output(cfg: JobConfig, verbose: bool = True, device="cuda") -> dict:
    """Verify cfg.output_dir against its manifest and rewrite only the
    missing or mismatched files; idempotent.

    The table comes from a checksum-valid ``table.npz`` sidecar (written by
    ``execute_job(keep_table=True)`` or the multiseq jobs) with zero
    recounting, or else from a recount of the dataset on ``device``, and a
    counts.npz is deflated on ``device`` (on the card for CUDA); for a
    multiseq directory the recount is the count job, whose table is the
    per-k-mer sums its bin files hold.  A damaged ``distances.json`` is
    reported and not rewritten (it needs the per-sequence table).  The recount and the rewrite use
    the config the manifest records, not the caller's: the manifest says
    what made the directory (the JAX package recounts a binary output with
    the caller's config and stamps it with the manifest's).  Returns
    verify_output's status after the repair."""
    status = manifest_mod.verify_output(cfg.output_dir)
    if status["ok"]:
        return status
    with open(os.path.join(cfg.output_dir, manifest_mod.MANIFEST)) as f:
        man = json.load(f)
    extras = man.get("extra_files", {})
    if man.get("binary") and ("shards" in man or any(n.startswith("counts.part") for n in extras)):
        # each process of a multi-host run owns its counts.part<N>.npz and
        # no one process holds the full table: re-run the shard's owner
        raise NotImplementedError(
            "sharded binary outputs (counts.part<N>.npz) are repaired "
            "by re-running their owning processes; single-process "
            "repair_output covers counts.npz only"
        )
    bad_extras = set(status["extra_missing"]) | set(status["extra_mismatched"])
    if man.get("binary") and "counts.npz" not in bad_extras:
        # the count table is the only artifact rebuilt here; a damaged
        # sibling needs its own job re-run: report rather than recount
        return status
    run_cfg = config_from_manifest(man["config"])
    table = manifest_mod.load_table_sidecar(cfg.output_dir)
    if table is not None:
        if verbose:
            print("repairing from the table.npz sidecar (no recount)")
    else:
        # the count job of the run's fields (a multiseq run's bins are its
        # per-k-mer sums)
        count_cfg = JobConfig(**{f.name: getattr(run_cfg, f.name)
                                 for f in dataclasses.fields(JobConfig)})
        res = execute_job(dataclasses_replace(count_cfg, write=False), verbose=False,
                          device=device)
        table = (res.words, res.counts, res.bins)
    words, counts, bins = table
    if man.get("binary"):
        if verbose:
            print("repairing binary output (counts.npz)")
        siblings = {n: h for n, h in extras.items() if n != "counts.npz"}
        writer.write_binary_with_manifest(
            cfg.output_dir, man["config"], words, counts, bins, run_cfg.k,
            extra_files=siblings, device=resolve_device(device),
        )
        return manifest_mod.verify_output(cfg.output_dir)
    bad = set(status["missing"]) | set(status["mismatched"])
    if verbose:
        print(f"repairing {len(bad)} bins: {sorted(bad)}")
    sel = np.isin(bins, list(bad))
    writer.write_bin_files(
        cfg.output_dir, words[sel], counts[sel], bins[sel], run_cfg.k,
        eof_sentinel=not run_cfg.use_ht, clean=False,  # a partial rewrite
    )
    return manifest_mod.verify_output(cfg.output_dir)
