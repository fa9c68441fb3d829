"""Distributed job driver — the port of ``fastkmer_tpu.parallel.driver``.

    host ingest -> [R, L] batches, R rounded up to a multiple of n    (host)
      -> LPT pre-pass on a 1-in-round(1/sample_fraction) sample of batches,
         or hash placement; exchange cap from the sampled histogram   (device)

then one of two paths:

* streaming (the default for k-mer transport and the sort engine):
  ``stream.DistributedCounter`` keeps each shard's table on its device
  across batches (exchange per batch, fan-in merges, spills past
  ``acc_cap``) and pulls it once at the end; a zero sequence lane keeps the
  sentinel unambiguous at k % 16 == 0;
* per batch (super-k-mer transport, the HT engine, or ``streaming=False``):
  a step per batch (full-mode extract kernel, route, exchange, owner count;
  resize-and-retry on dropped rows), each shard's unique rows to the host
  (``compact_shard_counts``), per-shard ``merge_partials`` and one lexsort.

Both end in the per-bin text or npz output + manifest of the single-device
job.  ``checkpoint_dir`` persists the streaming counter's spills, or the
per-batch path's compacted parts, every ``checkpoint_interval`` batches;
a forced ``prededup`` off the streaming path raises as it does in the JAX
package.

Over several ranks (``multihost.init_global_mesh``) every rank reads the
whole file and feeds its round-robin stripe of R/p-row batches, padded to
lockstep; the histograms, drop and collision counters and resume cursors
are reduced over the ranks, so every rank decides alike; each rank writes
its own shards' bins into the shared directory with a manifest shard, and
rank 0 merges the shards.  ``checkpoint_dir`` is then the rank's own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import pipeline
from ..config import JobConfig
from ..core.bits import empty_table, num_words
from ..ingest import batch as batching
from ..ingest.prefetch import prefetched
from ..ops import count_hash, count_sort
from ..output import manifest as manifest_mod
from ..output import writer
from ..utils.timing import StageTimer, fenced_span, maybe_profile
from . import exchange, multihost, partitioner, stream


class DistributedResult(NamedTuple):
    words: np.ndarray
    counts: np.ndarray
    bins: np.ndarray
    n_instances: int
    n_bases: int
    n_reads: int
    owner_map: np.ndarray
    balance: dict
    exchange_bytes: int
    timings: dict
    n_dedup_batches: int = 0  # streaming: batches shipped through the dedup transport
    n_batches: int = 0  # code batches streamed through the mesh
    exchange_cap: int = 0  # the per-(source, destination) cap of the last step
    exchange_retries: int = 0  # per batch: batches re-run at a doubled cap;
    # streaming: merge windows replayed at a doubled cap


def _write_output(cfg: JobConfig, mesh: exchange.Mesh, words, counts, bins,
                  keep_table: bool) -> None:
    """The single-device job's output in one process.  Over p ranks each
    rank holds only its shards' disjoint bins, so each writes only those
    into the shared directory, never cleaning the others' files: rank 0
    cleans once, a barrier orders the clean before any write, every rank
    writes its bins (or its counts.part<r>.npz under enableKryo) and its
    manifest shard, and after a second barrier rank 0 merges the shards."""
    if mesh.world == 1:
        pipeline.write_output(cfg, words, counts, bins, keep_table=keep_table,
                              device=mesh.devices[0])
        return
    comm, r = mesh.comm, mesh.rank
    if r == 0:
        writer.clean_output_dir(cfg.output_dir)
    comm.barrier("clean_output")
    hashes = extra = None
    if cfg.use_kryo_serializer:
        shard_name = f"counts.part{r}.npz"
        path = writer.write_binary(cfg.output_dir, words, counts, bins, cfg.k,
                                   name=shard_name, clean=False, device=mesh.devices[0])
        extra = {shard_name: manifest_mod.file_sha256(path)}
    else:
        hashes = writer.write_bin_files(cfg.output_dir, words, counts, bins, cfg.k,
                                        eof_sentinel=not cfg.use_ht, clean=False)
    manifest_mod.write_manifest_shard(
        cfg.output_dir, pipeline.dataclasses_dict(cfg), words, counts, bins, r,
        bin_hashes=hashes, extra_files=extra, binary=cfg.use_kryo_serializer,
    )
    comm.barrier("write_output")
    if r == 0:
        manifest_mod.merge_manifest_shards(cfg.output_dir, mesh.world)


def execute_job_distributed(
    cfg: JobConfig,
    mesh: exchange.Mesh,
    cap: int | None = None,
    smer_transport: bool = False,
    smax: int = 64,
    verbose: bool = True,
    streaming: bool | None = None,
    acc_cap: int | None = None,
    fanin: int = 4,
    checkpoint_dir: str | None = None,
    unique_ub: int | None = None,
    keep_table: bool = False,
    prededup: bool | None = None,
    trace_dir: str | None = None,
    checkpoint_interval: int = 32,
) -> DistributedResult:
    """Count cfg.dataset over ``mesh`` and (when cfg.write) write the same
    per-bin files, counts.npz and manifest as the single-device job.

    ``streaming`` defaults to True without ``smer_transport`` and without
    the HT engine (as in the JAX package); ``streaming=False`` with k-mer
    transport runs the per-batch path.  ``acc_cap`` (default: room for two
    batches of distinct k-mers per shard, a power of two) and ``fanin``
    size the streaming counter; ``prededup`` sets its dedup transport (None
    adaptive).  ``unique_ub`` makes the feed sync-free: no per-batch read
    of the drop counter and no retry; the run's total is checked once at
    the end and raises if a row was dropped.  ``cap`` fixes the starting
    per-(source, destination) capacity.  ``checkpoint_dir`` makes the run
    resumable (checkpoints every ``checkpoint_interval`` batches, emptied
    when the run completes), ``keep_table`` writes the table.npz sidecar,
    ``trace_dir`` wraps the run in a torch.profiler trace.

    Over several ranks every rank calls this with the same arguments (but
    its own ``checkpoint_dir``) and gets its own shards' table; the
    result's ``exchange_bytes`` and ``n_dedup_batches`` are the same on
    every rank, and ``timings["cross_rank"]`` holds the rank's seconds in
    collectives.  ``keep_table`` raises there: no rank holds the table."""
    with maybe_profile(trace_dir):
        return _execute_job_distributed(
            cfg, mesh, cap, smer_transport, smax, verbose, streaming, acc_cap, fanin,
            checkpoint_dir, checkpoint_interval, unique_ub, keep_table, prededup,
        )


def _execute_job_distributed(cfg: JobConfig, mesh: exchange.Mesh, cap: int | None,
                             smer_transport: bool, smax: int, verbose: bool,
                             streaming: bool | None, acc_cap: int | None, fanin: int,
                             checkpoint_dir: str | None, checkpoint_interval: int,
                             unique_ub: int | None, keep_table: bool,
                             prededup: bool | None) -> DistributedResult:
    if streaming is None:
        # the HT engine counts per batch on the received rows; the streaming
        # deferred accumulator is a sort-engine design
        streaming = not smer_transport and not cfg.use_ht
    if prededup is True and not streaming:
        raise NotImplementedError(
            "prededup requires the streaming mesh path (sort engine, k-mer "
            "transport); the per-batch smer/HT paths have no dedup step"
        )
    timer = StageTimer()
    n = mesh.size
    p = mesh.world
    devs = mesh.devices
    k, m, b = cfg.k, cfg.m, cfg.b
    if keep_table and p > 1:
        raise NotImplementedError(
            "keep_table writes one full-table sidecar; on a multi-host mesh "
            "each process holds only its chips' bins — run keep_table on a "
            "single-process mesh"
        )
    if verbose:
        print(cfg.describe())
        print(f"mesh: {n} shards, {', '.join(map(str, devs))} on rank {mesh.rank} of {p}, "
              f"transport={'super-k-mer' if smer_transport else 'k-mer'}")

    R, L = cfg.reads_per_batch, cfg.read_len
    if R % (n * p):
        R = -(-R // (n * p)) * (n * p)  # rows divide over the shards and the ranks' stripes

    def batches():
        # over p ranks each reads the file's R/p-row batches round-robin,
        # padded so that every rank takes the same number of steps
        it = batching.batch_file(cfg.dataset, cfg.sequence_type, k, R // p, L)
        return multihost.stripe_batches_padded(it, R // p, L, p, mesh.rank) if p > 1 else it

    # --- optional LPT pre-pass on a sample of batches.  Lockstep: ``est``
    # sums each histogram over the ranks, so every rank places bins alike
    hist = np.zeros(b, dtype=np.int64)
    if cfg.use_custom_partitioner:
        est = exchange.estimate_bin_sizes(mesh, k, m, b)
        take = max(1, int(round(1.0 / max(cfg.sample_fraction, 1e-9))))
        with fenced_span(timer, "lpt_prepass", *devs):
            for i, (codes, _, _) in enumerate(batches()):
                if i % take == 0:  # deterministic 1-in-take sampling
                    hist += est(exchange.shard_batch(mesh, codes)).cpu().numpy()
        # LPT over numPartitionTasks partitions, then tasks -> shards
        # round-robin; T == n when unset
        T = cfg.num_partition_tasks or n
        owner_map = (partitioner.lpt_owner_map(hist, T, b) % n).astype(np.int32)
        balance = partitioner.balance_stats(hist, owner_map, n)
    else:
        owner_map = partitioner.hash_owner_map(b, n)
        balance = {"sampled": False}

    # --- capacity from the sampled histogram (slack 2x, retried on overflow)
    positions = (R // n) * (L - k + 1)
    cap_limit = positions if not smer_transport else positions + 1
    if cap is None:
        if not hist.any():
            # hash placement: sample ONE batch for capacity sizing
            est = exchange.estimate_bin_sizes(mesh, k, m, b)
            with fenced_span(timer, "cap_sizing", *devs):
                for codes, _, _ in batches():
                    hist += est(exchange.shard_batch(mesh, codes)).cpu().numpy()
                    break
        cap = partitioner.size_exchange_cap(hist, owner_map, n, positions)
        if smer_transport:
            cap = min(cap + 1, cap_limit)  # records <= k-mers per (src, dst)

    ckpt = (manifest_mod.BatchCheckpointer(checkpoint_dir, checkpoint_interval)
            if checkpoint_dir else None)
    if streaming:
        res = _count_streaming(cfg, mesh, timer, batches, R // p, positions, cap, acc_cap,
                               fanin, owner_map, balance, unique_ub, prededup, ckpt, keep_table)
        return _with_cross_rank(res, mesh)

    def build_step(c: int):
        if smer_transport:
            return exchange.build_distributed_count_smer(mesh, k, m, b, c, smax, owner_map,
                                                         use_ht=cfg.use_ht)
        return exchange.build_distributed_count(mesh, k, m, b, c, owner_map,
                                                use_ht=cfg.use_ht)

    def step_bytes(c: int) -> int:
        return exchange.exchange_bytes_per_step(n, c, k, smax if smer_transport else None)

    step = build_step(cap)
    # keyed by shard: ownership is a function of the bin (owner_map[bin]),
    # so checkpointed parts re-split into the same per-shard merges on
    # resume (a k-mer merged under two shards would give two output rows)
    per_chip_parts: dict[int, list] = {}
    n_reads = n_bases = xbytes = retries = n_batches = 0
    sync_free = unique_ub is not None
    dropped_total = None  # device scalar under sync_free, read once at the end
    collision_total = None  # HT engine: device scalar, read once at the end
    # every compacted part visits the host anyway, so the parts themselves
    # are the checkpoint unit (the spill flow of BatchCheckpointer)
    skip = 0
    held: list = []  # every part of the run, loaded ones first, all shards
    if ckpt is not None:
        skip = _resume_cursor(ckpt, mesh)
        held = ckpt.load_parts()
        for part in held:
            _split_part_by_owner(part, owner_map, per_chip_parts)
    for i, (codes, nr, nb) in enumerate(prefetched(batches())):
        n_batches += 1
        if i < skip:  # counted before the interruption
            n_reads += nr
            n_bases += nb
            continue
        with fenced_span(timer, "device_step", *devs):
            shards = exchange.shard_batch(mesh, codes)
            sc = step(shards)
        # batches are independent here, so overflow recovery is a straight
        # resize-and-retry of the same shards.  Lockstep: sc.dropped is the
        # sum over the ranks, so every rank retries the same batch
        while not sync_free and int(sc.dropped):
            if cap >= cap_limit:
                raise RuntimeError(
                    f"exchange overflow at worst-case cap={cap}: "
                    f"{int(sc.dropped)} entries dropped"
                )
            xbytes += step_bytes(cap)
            cap = min(cap * 2, cap_limit)
            retries += 1
            if verbose:
                print(f"exchange overflow; retrying batch at cap={cap}")
            step = build_step(cap)
            sc = None  # free the failed step's buffers before the retry
            with fenced_span(timer, "device_step", *devs):
                sc = step(shards)
        if sync_free:
            dropped_total = sc.dropped if dropped_total is None else dropped_total + sc.dropped
        if cfg.use_ht:
            collision_total = (sc.collision if collision_total is None
                               else collision_total + sc.collision)
        xbytes += step_bytes(cap)
        with fenced_span(timer, "host_compact", *devs):
            for c, part in exchange.compact_shard_counts(sc, with_chips=True):
                per_chip_parts.setdefault(c, []).append(part)
                if ckpt is not None:
                    held.append(part)
        del sc, shards
        n_reads += nr
        n_bases += nb
        if ckpt is not None and (i + 1) % ckpt.interval == 0:
            with timer.span("checkpoint"):
                # a checkpoint claims its batches complete, so the sync-free
                # drop counter is verified first
                _check_dropped(dropped_total, cap)
                dropped_total = None
                ckpt.save_spills(i + 1, held)
    _check_dropped(dropped_total, cap)
    # lockstep: the collision flags are summed over the ranks, so every rank raises
    if collision_total is not None and int(collision_total):
        raise count_hash.FingerprintCollision(
            "64-bit fingerprint collision on the mesh; re-run with useHT=0"
        )

    W = num_words(k)
    with timer.span("merge"):
        merged = [
            pipeline.merge_partials(per_chip_parts[c], W)
            for c in sorted(per_chip_parts)
            if per_chip_parts[c]
        ]
        merged = [p for p in merged if p[0].shape[0]]
        if merged:
            words = np.concatenate([p[0] for p in merged])
            counts = np.concatenate([p[1] for p in merged])
            bins = np.concatenate([p[2] for p in merged])
            order = np.lexsort(tuple(words[:, w] for w in reversed(range(W))))
            words, counts, bins = words[order], counts[order], bins[order]
        else:
            words, counts, bins = empty_table(W)

    if cfg.write:
        with timer.span("write_output"):
            _write_output(cfg, mesh, words, counts, bins, keep_table)
    if ckpt is not None:
        ckpt.clear()  # the run completed
    return _with_cross_rank(DistributedResult(
        words, counts, bins, int(counts.sum()), n_bases, n_reads,
        owner_map, balance, xbytes, timer.as_dict(),
        n_batches=n_batches, exchange_cap=cap, exchange_retries=retries,
    ), mesh)


def _with_cross_rank(res: DistributedResult, mesh: exchange.Mesh) -> DistributedResult:
    """Over several ranks, add the rank's seconds in collectives to the
    timings as ``cross_rank``."""
    if mesh.world == 1:
        return res
    return res._replace(timings={**res.timings, "cross_rank": mesh.comm.seconds})


def _resume_cursor(ckpt, mesh: exchange.Mesh) -> int:
    """The batch to resume from.  Lockstep: over several ranks the fleet
    minimum, with every rank's checkpoint rolled back to it (a crash can
    land between the ranks' cursor writes)."""
    skip = ckpt.completed_batches()
    if mesh.world > 1:
        skip = ckpt.rollback_to(multihost.agree_min(skip, mesh.comm))
    return skip


def _count_streaming(cfg: JobConfig, mesh: exchange.Mesh, timer: StageTimer, batches,
                     R: int, positions: int, cap: int, acc_cap: int | None, fanin: int,
                     owner_map: np.ndarray, balance: dict, unique_ub: int | None,
                     prededup: bool | None, ckpt, keep_table: bool) -> DistributedResult:
    """The streaming branch of the JAX driver (driver.py:237-315) on this
    rank's R-row batches.  With a checkpointer, a forced spill every
    ``ckpt.interval`` batches persists the shards' tables; a resume loads
    them back and skips their batches."""
    # k % 16 == 0: a constant-zero seq lane keeps the sentinel unambiguous
    flagged = not count_sort.sentinel_safe_for(cfg.k)
    if acc_cap is None:
        # room for ~2 batches of all-distinct k-mers per shard before a spill
        acc_cap = 1 << max(14, (2 * mesh.size * positions - 1).bit_length())
    ctr = stream.DistributedCounter(
        mesh, cfg.k, cfg.m, cfg.b, cap, acc_cap, owner_map=owner_map, fanin=fanin,
        with_seq=flagged, unique_ub=unique_ub, prededup=prededup,
    )
    zero_sids = np.zeros(R, np.int32) if flagged else None
    skip = 0
    if ckpt is not None:
        skip = _resume_cursor(ckpt, mesh)
        ctr.host_spills.extend(ckpt.load_parts())
    n_batches = 0
    for i, (codes, nr, nb) in enumerate(prefetched(batches())):
        n_batches += 1
        if i < skip:  # counted before the interruption
            ctr.n_reads += nr
            ctr.n_bases += nb
            continue
        with fenced_span(timer, "device_step", *mesh.devices):
            ctr.feed(codes, n_reads=nr, n_bases=nb, seq_ids=zero_sids)
        if ckpt is not None and (i + 1) % ckpt.interval == 0:
            with fenced_span(timer, "checkpoint", *mesh.devices):
                ctr.spill()
                ckpt.save_spills(i + 1, ctr.host_spills)
    with fenced_span(timer, "merge", *mesh.devices):
        words, counts, bins = ctr.finalize()
        if flagged:
            words = words[:, : num_words(cfg.k)]  # drop the zero lane
    if cfg.write:
        with timer.span("write_output"):
            _write_output(cfg, mesh, words, counts, bins, keep_table)
    if ckpt is not None:
        ckpt.clear()  # the run completed
    return DistributedResult(
        words, counts, bins, int(counts.sum()), ctr.n_bases, ctr.n_reads,
        owner_map, balance, ctr.exchange_bytes, timer.as_dict(),
        n_dedup_batches=ctr.n_dedup_batches, n_batches=n_batches,
        exchange_cap=ctr.cap, exchange_retries=ctr.n_retries,
    )


def _split_part_by_owner(part, owner_map: np.ndarray, out: dict) -> None:
    """Re-split a checkpointed (words, counts, bins) part into per-shard
    sub-parts by the bin -> shard map (a resume recomputes the same map:
    the hash map is a formula, the LPT map comes from the same sample)."""
    words, counts, bins = part
    chips = owner_map[bins]
    for c in np.unique(chips):
        idx = chips == c
        out.setdefault(int(c), []).append((words[idx], counts[idx], bins[idx]))


def _check_dropped(dropped_total, cap: int) -> None:
    """Sync-free (unique_ub) feed: one read of the run's accumulated
    exchange-drop counter; any drop is fatal (the batches are gone, so no
    retry is possible).  Lockstep: each step's counter is the sum over the
    ranks, so every rank raises alike."""
    if dropped_total is None:
        return
    total = int(dropped_total)
    if total:
        raise RuntimeError(
            f"sync-free per-batch run dropped {total} exchange entries at "
            f"cap={cap}; re-run without unique_ub (per-batch retry) or with "
            "a larger cap"
        )
