"""Streaming distributed counter with per-shard device-resident tables —
the port of ``fastkmer_tpu.parallel.stream`` on ``exchange.Mesh``, of one
process or of several ranks.

The per-batch mesh path (parallel.driver with super-k-mer transport) pulls
every batch's per-shard table to the host.  This counter keeps all
cross-batch state on the devices:

  per batch   exchange: full-mode extract kernel -> route -> all-to-all
              (no sort per batch; the received rows wait on their shard's
              device as a "pending" part)
  every ``fanin`` batches (or when the accumulator budget forces it)
              merge, per shard: ONE weighted count sort over (pending rows,
              accumulated uniques) + run totals + compaction
              (count_sort.compact_marked) back to the [acc_cap] accumulator

This is the device analogue of the reference's reduce-side state (Spark
shuffle files + ``reduceByKey`` aggregation buffers,
SparkBinKmerCounter.scala:1035).

Duplication-aware transport (``prededup``): each shard counts its batch
rows locally and routes (k-mer words, weight) for its distinct rows only,
the mesh form of the reference's super-k-mer shuffle compression
(SparkBinKmerCounter.scala:34-169, :1031-1036).  The mode is adaptive, as
in the JAX package: probe batches measure the in-batch distinct ratio and
dedup engages below ENGAGE_BELOW, at batch indices that depend on the
input only.

The host moves scalars (drop and overflow counters, at merge boundaries)
and pulls each shard's table once at the end, or when the distinct count
outgrows ``acc_cap``, at a merge boundary (a spill).  ``cap`` bounds the
rows per (source, destination) exchange slot (``cap_d`` in dedup mode),
``acc_cap`` the distinct k-mers each shard holds; overflow is counted,
never silent.

The merge schedule (fan-in, the power-of-two trigger, spills and window
retries) is the JAX counter's, so both packages merge the same windows and
report the same ``exchange_bytes``, ``n_retries`` and ``n_dedup_batches``.

Over several ranks every host decision reads a value reduced over the
ranks (the probe ratio, the drop counters, the shards' unique counts and
the overflow totals), and every bound counts global positions, so all
ranks take the same branch at the same batch and the collectives stay in
step; ``exchange_bytes`` and ``n_dedup_batches`` are then the same on
every rank, and each rank's ``finalize`` returns its own shards' table.
Not carried over, because only ``lax.sort`` or the TPU host link needed
them: the 64Ki / power-of-two padding of the merge input and the
asynchronous spill copies (spills here are plain synchronous copies).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import pipeline
from ..core.bits import num_words
from ..ops import binhash, count_sort, cuda_extract
from . import exchange

_WT_LIMIT = count_sort.WEIGHT_LIMIT  # int32 run-total wrap guard


class AccState(NamedTuple):
    cols: list  # per local shard: W int32 [acc_cap] sentinel-padded unique lanes, sorted
    wts: list  # per local shard: int32 [acc_cap] counts
    n_unique: torch.Tensor  # [n_local] int64, first shard's device
    dropped: torch.Tensor  # [] int64 cumulative exchange overflow, first shard's device
    overflow: torch.Tensor  # [] int64 cumulative accumulator overflow, first shard's device


class _Part(NamedTuple):
    """One exchange result awaiting the fan-in merge.

    cols:  per shard, W int32 [n·cap] received lanes (sentinel on dead slots)
    wts:   per shard, int32 [n·cap] weights for dedup parts, None for raw
           parts (raw rows weigh 1 where not sentinel)
    ndrop: [] rows this exchange dropped, summed over this rank's shards
    """

    cols: list
    wts: list | None
    ndrop: torch.Tensor


def _quantize_cap(v: int) -> int:
    """Round a capacity UP to the {pow2, 1.5*pow2} grid (<= 50% padding),
    floor 512."""
    v = max(512, v)
    p2 = 1 << (v - 1).bit_length()
    return p2 * 3 // 4 if p2 * 3 // 4 >= v else p2


class DistributedCounter:
    """Multi-batch streaming counter over a 1-D mesh (k % 16 != 0, or a
    sequence lane).

    ``cap``      per-(source, destination) exchange capacity (k-mers).
    ``acc_cap``  distinct k-mers held on each shard between host spills.
    ``fanin``    exchanges buffered per merge.
    ``with_seq`` a per-read sequence id rides the exchange as one extra
                 int32 key lane, so the tables count (k-mer, seq) pairs; the
                 driver sets it with ids of 0 for k % 16 == 0, where the
                 lane keeps the all-ones sentinel unambiguous.
    ``unique_ub`` caller-asserted bound on TOTAL distinct k-mers (e.g.
                 genome length): acc_cap grows to cover it, the host-side
                 room checks, the per-merge drop-counter reads and window
                 retries are skipped, and the device counters are checked
                 once at finalize.
    ``prededup`` pre-exchange weighted dedup.  None (default) is adaptive:
                 every PROBE_EVERY-th batch (batch 0 included) ships in
                 dedup mode as a probe, and its distinct ratio, read
                 PROBE_LAG batches later, sets the mode.  True/False force
                 the mode.
    """

    PROBE_EVERY = 16
    WARMUP_PROBES = frozenset((0,))
    # engage threshold of the JAX package (measured there on a TPU:
    # break-even near a per-shard distinct ratio of 0.35)
    ENGAGE_BELOW = 0.30
    # batches between a probe's dispatch and the read of its ratio: mode
    # flips land at indices that are a function of the input only
    PROBE_LAG = 3

    def __init__(self, mesh: exchange.Mesh, k: int, m: int, B: int, cap: int, acc_cap: int,
                 owner_map: np.ndarray, fanin: int = 4, with_seq: bool = False,
                 retry_on_overflow: bool = True, unique_ub: int | None = None,
                 prededup: bool | None = None):
        if not (count_sort.sentinel_safe_for(k) or with_seq):
            raise ValueError(
                "streaming counter needs k % 16 != 0 (or a seq lane, which is "
                "itself sentinel-safe)"
            )
        self.mesh = mesh
        self.k, self.m, self.B = k, m, B
        self.with_seq = with_seq
        self.Wk = num_words(k)  # k-mer words only
        self.W = self.Wk + (1 if with_seq else 0)  # key lanes incl. seq
        self.n = mesh.size  # global shards
        self.nl = mesh.n_local
        self.dev0 = mesh.devices[0]
        self.cap = cap
        self.assume_fits = unique_ub is not None
        if unique_ub is not None:
            # next 64Ki granule + 2 granules of slack: bins partition k-mers
            # across shards, so one shard holds <= the global bound
            acc_cap = max(acc_cap, (-(-int(unique_ub) // (1 << 16)) + 2) * (1 << 16))
        self.acc_cap = acc_cap
        self.fanin = fanin
        self.owner = np.asarray(owner_map, dtype=np.int32)
        self._owner_tabs = exchange._owner_tables(mesh, self.owner)
        self.block_sort = count_sort.block_sort_opt_in()
        self.state = self._init_state()
        self.pending: list[_Part] = []
        self.host_spills: list = []  # (words, counts, bins) numpy triples
        self._acc_ub = 0  # conservative upper bound on per-shard uniques
        self._pend_ub = 0  # conservative upper bound on pending new uniques
        self._wt_dev = 0  # bound on total instance weight on the devices
        self.rows = 0  # per-shard rows buffered in pending parts
        self.n_bases = 0
        self.n_reads = 0
        self.retry_on_overflow = retry_on_overflow
        self._window: list = []  # current merge window's inputs, for replay
        self._cap_limit = cap  # grows with observed per-source positions
        self.exchange_bytes = 0  # cumulative bytes crossing the exchange
        self.n_retries = 0
        self.merge_rows: list[int] = []  # per-shard rows of each merge
        # --- adaptive pre-exchange dedup state ---
        self.prededup = prededup
        # dedup-mode capacity: the raw cap, or under unique_ub the bound
        # itself (a shard's batch distinct count cannot exceed it)
        self.cap_d = cap
        if unique_ub is not None:
            self.cap_d = min(cap, _quantize_cap(int(unique_ub)))
        # a drop-forced doubling of cap_d is a floor later retunes keep
        self._cap_d_floor = 0
        self._dedup_mode = prededup is True
        self._batch_i = 0
        self.n_dedup_batches = 0
        self._probe_pending: list = []  # (consume_at, positions, distinct count)

    def _init_state(self) -> AccState:
        zero = torch.zeros((), dtype=torch.int64, device=self.dev0)
        return AccState(
            cols=[tuple(torch.full((self.acc_cap,), -1, dtype=torch.int32, device=d)
                        for _ in range(self.W)) for d in self.mesh.devices],
            wts=[torch.zeros(self.acc_cap, dtype=torch.int32, device=d)
                 for d in self.mesh.devices],
            n_unique=torch.zeros(self.nl, dtype=torch.int64, device=self.dev0),
            dropped=zero,
            overflow=zero,
        )

    # ------------------------------------------------------------------ #
    # per-batch exchange: extract -> route -> all-to-all (no sort)       #
    # ------------------------------------------------------------------ #
    def _key_cols(self, codes: torch.Tensor, sids: torch.Tensor | None, masked: bool):
        """Full-mode extract of one shard's stripe -> (extract, W key
        lanes); ``masked`` writes the sentinel on invalid windows."""
        ex = cuda_extract.extract_full(codes, self.k, self.m, self.B)
        cols = [ex.words[:, w] for w in range(self.Wk)]
        if self.with_seq:
            R, L = codes.shape
            cols.append(sids[:, None].expand(R, L - self.k + 1).reshape(-1))
        if masked:
            cols = [torch.where(ex.valid, c, -1) for c in cols]
        return ex, cols

    def _exchange_raw(self, shards: list, sids: list | None):
        """Raw transport: one [n·cap] lane per key word per (source,
        destination).  Dead slots ship as the sentinel, so no ok lane
        crosses the exchange."""
        send, drops = [], []
        for s, codes in enumerate(shards):
            ex, cols = self._key_cols(codes, None if sids is None else sids[s], False)
            owner = self._owner_tabs[s][ex.bins]
            routed, _, ndrop = exchange.route_by_owner(
                owner, ex.valid, tuple(cols), self.n, self.cap, fills=(-1,) * self.W
            )
            del ex, cols, owner
            send.append(list(routed))
            drops.append(ndrop.to(self.dev0))
        recv = exchange._exchange(self.mesh, self.cap, send)
        return [tuple(r) for r in recv], torch.stack(drops).sum()

    def _exchange_dedup(self, shards: list, sids: list | None):
        """Dedup transport: each shard counts its batch rows (one extra
        W-key sort), then routes (k-mer words, int32 weight) for its
        distinct rows only.  Also returns the sum of this rank's shards'
        distinct counts, the adaptive controller's signal."""
        send, drops = [], []
        n_u = 0
        for s, codes in enumerate(shards):
            _, cols = self._key_cols(codes, None if sids is None else sids[s], True)
            sc = count_sort.count_presentineled(cols)
            del cols
            # bins (and so owners) are needed at the distinct rows only;
            # the others are not routed
            idx = torch.nonzero(sc.is_uniq).squeeze(1)
            n_u += idx.numel()
            owner = torch.zeros_like(sc.counts, dtype=torch.int64)
            owner[idx] = self._owner_tabs[s][
                binhash.bins_from_words(sc.words[idx, : self.Wk], self.k, self.m, self.B)
            ]
            rcols = tuple(sc.words[:, w] for w in range(self.W)) + (sc.counts,)
            routed, _, ndrop = exchange.route_by_owner(
                owner, sc.is_uniq, rcols, self.n, self.cap_d,
                fills=(-1,) * self.W + (0,),
            )
            del sc, idx, owner, rcols
            send.append(list(routed))
            drops.append(ndrop.to(self.dev0))
        recv = exchange._exchange(self.mesh, self.cap_d, send)
        cols = [tuple(r[: self.W]) for r in recv]
        wts = [r[self.W] for r in recv]
        return cols, wts, torch.stack(drops).sum(), n_u

    # ------------------------------------------------------------------ #
    # merge: pending parts + accumulator -> accumulator, per shard       #
    # ------------------------------------------------------------------ #
    def _merge_pending(self) -> None:
        if not self.pending:
            return
        # under unique_ub the drop-counter read (a host sync) is skipped;
        # the accumulated state.dropped raises at finalize
        if self.retry_on_overflow and not self.assume_fits:
            self._retry_window_if_dropped()
        self.merge_rows.append(
            sum(int(p.cols[0][0].shape[0]) for p in self.pending) + self.acc_cap
        )
        pending, self.pending = self.pending, []
        ndrop = torch.stack([p.ndrop for p in pending]).sum()
        cols, wts, n_unique, over = [], [], [], []
        for d in range(self.nl):
            parts = [(p.cols[d], None if p.wts is None else p.wts[d]) for p in pending]
            for p in pending:  # the shard's part buffers go with its merge
                p.cols[d] = None
                if p.wts is not None:
                    p.wts[d] = None
            zero = torch.zeros((), dtype=torch.int64, device=self.mesh.devices[d])
            acc = (self.state.cols[d], self.state.wts[d], None, zero)
            self.state.cols[d] = self.state.wts[d] = None
            c, w, n_u, o = pipeline._acc_merge(parts, acc, self.block_sort)
            del acc
            cols.append(c)
            wts.append(w)
            n_unique.append(n_u.to(self.dev0))
            over.append(o.to(self.dev0))
        self.state = AccState(
            cols=cols, wts=wts, n_unique=torch.stack(n_unique),
            dropped=self.state.dropped + ndrop,
            overflow=self.state.overflow + torch.stack(over).sum(),
        )
        self._window = []
        self.rows = 0
        self._acc_ub = min(self._acc_ub + self._pend_ub, self.acc_cap)
        self._pend_ub = 0

    def _ensure_room(self, incoming: int) -> None:
        """Keep the next merge's unique-count bound within acc_cap, spilling
        the accumulator to the host when it cannot absorb the incoming
        batch.  Conservative bounds avoid device reads in the common case.
        Lockstep: the bounds count global positions and the occupancy is
        the fullest shard of any rank, so every rank spills together."""
        if self._acc_ub + self._pend_ub + incoming <= self.acc_cap:
            return
        stats = self._stats()  # exact occupancy before deciding to spill
        self._acc_ub = max(stats["n_unique"], default=0)
        while self._acc_ub + self._pend_ub + incoming > self.acc_cap:
            if self.pending:
                # merge first: duplicates may collapse the pending bound
                self._merge_pending()
                stats = self._stats()
                self._acc_ub = max(stats["n_unique"], default=0)
            elif self._acc_ub > 0:
                self._raise_if_lost(stats)
                self._spill(stats)
            else:
                # a single batch exceeds acc_cap: the overflow counter
                # records the loss and finalize raises
                break

    # ------------------------------------------------------------------ #
    # adaptive dedup controller                                          #
    # ------------------------------------------------------------------ #
    def _consume_probes(self) -> None:
        """Apply the distinct ratios of probe/dedup batches to the
        transport mode and ``cap_d``, each at its dispatch index +
        PROBE_LAG.  A forced prededup=True uses them for ``cap_d`` only.
        Lockstep: the distinct count is summed over the ranks, so every
        rank flips mode and retunes at the same batch."""
        while self._probe_pending:
            consume_at, pos, n_u = self._probe_pending[0]
            if self._batch_i < consume_at:
                break
            self._probe_pending.pop(0)
            if self.mesh.world > 1:
                n_u = int(self.mesh.comm.reduce(torch.tensor([n_u]))[0])
            ratio = n_u / max(pos, 1)
            if self.prededup is None:
                self._dedup_mode = ratio < self.ENGAGE_BELOW
            if self._dedup_mode or self.prededup is True:
                self._retune_cap_d(ratio)

    def _retune_cap_d(self, ratio: float) -> None:
        """cap_d ~ cap · ratio · 1.5 on the {pow2, 1.5·pow2} grid, never
        above the raw cap nor below a drop-forced floor.  Under unique_ub
        cap_d stays at its provably safe size (there is no retry there)."""
        if self.assume_fits:
            return
        target = min(_quantize_cap(int(self.cap * min(1.0, ratio) * 1.5)), self.cap)
        self.cap_d = max(target, self._cap_d_floor)

    def feed(self, codes: np.ndarray, n_reads: int = 0, n_bases: int = 0,
             seq_ids: np.ndarray | None = None) -> None:
        """Exchange one batch: this rank's [R/p, L] stripe of a global
        [R, L] batch (R divisible by the mesh size).  A CPU shard shares
        ``codes`` and ``seq_ids``: pass fresh arrays.  The capacity and
        weight bounds count the global batch's positions, as every rank
        must reach the same decisions."""
        R, L = codes.shape
        R *= self.mesh.world
        positions = R * max(L - self.k + 1, 0)
        if self._wt_dev + positions > _WT_LIMIT:
            # int32 run-total wrap guard; applies under unique_ub too (it
            # bounds weights, not capacity)
            self.spill()
        self._consume_probes()
        if self.prededup is None:
            use_dedup = (
                self._dedup_mode
                or self._batch_i % self.PROBE_EVERY == 0
                or self._batch_i in self.WARMUP_PROBES
            )
        else:
            use_dedup = self.prededup
        mode_cap = self.cap_d if use_dedup else self.cap
        # per-shard new-unique bound: no more than its n·cap received slots,
        # nor more than the batch holds
        uniq_charge = min(positions, self.n * mode_cap)
        if not self.assume_fits:
            self._ensure_room(uniq_charge)
        if len(self.pending) >= max(2, self.fanin - 2):
            # the JAX counter's power-of-two merge trigger (lax.sort is
            # cheaper at a pow2 row count there); kept because it decides
            # the merge windows, and with them retries and spills
            cur = self.rows + self.acc_cap
            p2 = 1 << (cur - 1).bit_length()
            if p2 <= cur * 1.10 and cur + self.n * mode_cap > p2:
                self._merge_pending()
        shards = exchange.shard_batch(self.mesh, codes)
        sids = None
        if self.with_seq:
            sids = exchange.shard_batch(self.mesh, np.asarray(seq_ids, dtype=np.int32))
        self._dispatch(shards, sids, use_dedup, positions)
        src_positions = (-(-R // self.n)) * max(L - self.k + 1, 0)
        if not self.assume_fits:  # under unique_ub a window is never replayed
            self._window.append((shards, sids, positions, use_dedup))
        self._cap_limit = max(self._cap_limit, src_positions)
        self._pend_ub += uniq_charge
        self._wt_dev += positions  # dedup rows carry weights: full charge
        self.n_reads += n_reads
        self.n_bases += n_bases
        self._batch_i += 1
        if len(self.pending) >= self.fanin:
            self._merge_pending()

    def _dispatch(self, shards: list, sids: list | None, use_dedup: bool,
                  positions: int) -> None:
        if use_dedup:
            cols, wts, ndrop, n_u = self._exchange_dedup(shards, sids)
            self.pending.append(_Part(cols, wts, ndrop))
            self.rows += self.n * self.cap_d
            self.n_dedup_batches += 1
            # W key lanes + the int32 weight lane
            self.exchange_bytes += self.n * self.cap_d * (self.W + 1) * 4
            if self.prededup is not False:
                self._probe_pending.append((self._batch_i + self.PROBE_LAG, positions, n_u))
        else:
            cols, ndrop = self._exchange_raw(shards, sids)
            self.pending.append(_Part(cols, None, ndrop))
            self.rows += self.n * self.cap
            # key lanes only: dead slots ship as the sentinel
            self.exchange_bytes += self.n * self.cap * self.W * 4

    def _retry_window_if_dropped(self) -> None:
        """Exchange-overflow recovery: read the window's drop counters and,
        if a row was dropped, grow the overflowed capacity (doubled, clipped
        at the per-source worst case where overflow is impossible) and
        replay the window's batches, each in its original mode.  The replay
        re-runs the feed's capacity checks, so it may merge sub-windows and
        spill between them; ``self._window`` always holds exactly the
        replayed prefix, so a nested retry replays a consistent set.
        Lockstep: the drops are summed over the ranks, so every rank
        replays the same windows at the same capacities."""
        while True:
            drops = torch.stack([p.ndrop for p in self.pending])
            if self.mesh.world > 1:
                drops = self.mesh.comm.reduce(drops)
            drops = drops.tolist()
            if sum(drops) == 0:
                return
            # each part's capacity at dispatch is its lane width / n
            raw_hi = dedup_hi = 0
            for p, d in zip(self.pending, drops):
                if not d:
                    continue
                part_cap = int(p.cols[0][0].shape[0]) // self.n
                if part_cap >= self._cap_limit:
                    mode = "dedup cap_d" if p.wts is not None else "raw cap"
                    raise RuntimeError(
                        f"exchange overflow at worst-case {mode}={part_cap}: "
                        f"{sum(drops)} entries dropped"
                    )
                if p.wts is not None:
                    dedup_hi = max(dedup_hi, part_cap)
                else:
                    raw_hi = max(raw_hi, part_cap)
            if raw_hi:
                self.cap = min(max(self.cap, raw_hi) * 2, self._cap_limit)
            if dedup_hi:
                self.cap_d = min(max(self.cap_d, dedup_hi) * 2, self._cap_limit)
                self._cap_d_floor = self.cap_d  # retunes may not undo this
            self.n_retries += 1
            window = self._window
            self.pending = []
            self._window = []
            self._pend_ub = 0
            self.rows = 0
            for shards, sids, pos, use_dedup in window:
                mode_cap = self.cap_d if use_dedup else self.cap
                uniq_charge = min(pos, self.n * mode_cap)
                self._wt_dev += pos
                self._ensure_room(uniq_charge)
                self._dispatch(shards, sids, use_dedup, pos)
                self._window.append((shards, sids, pos, use_dedup))
                self._pend_ub += uniq_charge

    def _stats(self) -> dict:
        """Counters of the merges so far (pending parts excluded): one read.
        ``n_unique`` has an entry per global shard; over several ranks the
        counters are summed over the ranks (one reduction), so every rank
        reads the same values and decides alike."""
        n_unique = self.state.n_unique
        if self.mesh.world > 1:
            n_unique = torch.zeros(self.n, dtype=torch.int64, device=self.dev0)
            n_unique[self.mesh.offset : self.mesh.offset + self.nl] = self.state.n_unique
        vals = torch.cat([n_unique, self.state.dropped[None], self.state.overflow[None]])
        if self.mesh.world > 1:
            vals = self.mesh.comm.reduce(vals)
        vals = vals.tolist()
        return {"n_unique": vals[: self.n], "dropped": vals[self.n],
                "overflow": vals[self.n + 1]}

    def check(self) -> dict:
        """Merge the pending parts into the accumulator, then return the
        capacity counters."""
        self._merge_pending()
        return self._stats()

    def _raise_if_lost(self, stats: dict) -> None:
        if stats["dropped"]:
            raise RuntimeError(
                f"exchange overflow: {stats['dropped']} entries; raise cap"
            )
        if stats["overflow"]:
            raise RuntimeError(
                f"accumulator overflow: {stats['overflow']} uniques; raise acc_cap"
            )

    def spill(self) -> None:
        """Pull the accumulated per-shard tables to the host and reset the
        accumulator: acc_cap is a budget, not a limit."""
        stats = self.check()
        self._raise_if_lost(stats)
        self._spill(stats)

    def _spill(self, stats: dict) -> None:
        self.host_spills.extend(self._pull_tables(stats))
        self.state = self._init_state()
        self._acc_ub = 0
        self._wt_dev = 0  # spilled weights left the devices (pending is empty)

    def _pull_tables(self, stats: dict) -> list:
        """Per local shard with uniques: (words uint32 [u, W], counts int64,
        bins int32) on the host; bins from the k-mer words (not the seq
        lane)."""
        out = []
        for d in range(self.nl):
            u = stats["n_unique"][self.mesh.offset + d]
            if u == 0:
                continue
            words = torch.stack([c[:u] for c in self.state.cols[d]], 1)
            bins = binhash.bins_from_words(words[:, : self.Wk], self.k, self.m, self.B)
            out.append(pipeline.table_to_host(words, self.state.wts[d][:u], bins))
        return out

    def finalize(self):
        """-> (words [U, W], counts [U], bins [U]) merged across this rank's
        shards.

        Bins partition k-mers across shards, so the shards' tables are
        disjoint; a shard may spill the same k-mer twice, so the host merge
        is a weighted group-by (pipeline.merge_partials)."""
        stats = self.check()
        self._raise_if_lost(stats)
        return pipeline.merge_partials(self.host_spills + self._pull_tables(stats), self.W)
