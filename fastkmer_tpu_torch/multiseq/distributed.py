"""Multisequence counting on the streaming mesh — the port of
``fastkmer_tpu.multiseq.distributed``.

The reference's multiseq job is the same shuffle with sequence-tagged
payloads (``aggregateByKey``, SparkMultiSequenceKmerCounter.scala:587-588).
Here the sequence id rides the exchange as one extra int32 key lane
(``parallel.stream.DistributedCounter(with_seq=True)``, kernel B per
shard) and each shard keeps its (k-mer, seq) count table on its device
across batches.  Distances are accumulated on the host from the merged
table (``multiseq.pipeline.accumulate_distances``) and written, as on the
single device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import num_words
from ..ingest import batch as batching
from ..ingest.prefetch import prefetched
from ..output import manifest as manifest_mod
from ..parallel import exchange, partitioner, stream
from ..utils.timing import StageTimer, fenced_span
from . import distances as dist_mod
from .pipeline import MultiseqResult, SequenceTags, _write_multiseq_output, pair_distances


def execute_multiseq_job_distributed(cfg, mesh: exchange.Mesh, cap: int | None = None,
                                     verbose: bool = True,
                                     checkpoint_dir: str | None = None,
                                     checkpoint_interval: int = 32,
                                     unique_ub: int | None = None,
                                     prededup: bool | None = None,
                                     keep_table: bool = False) -> MultiseqResult:
    """Mesh form of execute_multiseq_job (same MultiseqConfig and result).

    Honors ``use_custom_partitioner``/``num_partition_tasks`` with the
    sampled LPT pre-pass of the count job's driver (the reference multiseq
    orchestrator supports the custom partitioner too,
    SparkMultiSequenceKmerCounter.scala:580-583); the exchange capacity is
    sized from the sampled histogram.  ``checkpoint_dir`` makes the run
    resumable through the counter's spills; ``unique_ub`` (a bound on
    distinct (k-mer, sequence) PAIRS) makes the feed sync-free;
    ``prededup`` sets the dedup transport (the seq id is a key lane, so a
    shard counts (k-mer, seq) pairs before routing; None adaptive).

    One process only: with ``torch.distributed`` initialised over more than
    one rank it raises, as the JAX package does over more than one process
    (its ingest is not striped across processes and its distances are per
    process)."""
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "distributed multiseq runs on a single-process mesh; multi-host "
            "ingest striping + distance aggregation are not wired for it"
        )
    timer = StageTimer()
    measure = dist_mod.get_measure(cfg.distance_measure)
    if verbose:
        print(cfg.describe())
    n = mesh.size
    devs = mesh.devices
    W = num_words(cfg.k)
    R = -(-cfg.reads_per_batch // n) * n
    L = cfg.read_len
    tags = SequenceTags()  # ids are first-seen, the same on every pass

    def batches():
        return batching.batch_codes_dense_tagged(tags.reads(cfg), R, L)

    # --- optional LPT pre-pass on a sample of batches (reference:
    # SparkMultiSequenceKmerCounter.scala:580-583, 1%/10% sampling) ---
    hist = np.zeros(cfg.b, dtype=np.int64)
    if cfg.use_custom_partitioner:
        est = exchange.estimate_bin_sizes(mesh, cfg.k, cfg.m, cfg.b)
        take = max(1, int(round(1.0 / max(cfg.sample_fraction, 1e-9))))
        with fenced_span(timer, "lpt_prepass", *devs):
            for i, (codes, _sids, _, _) in enumerate(batches()):
                if i % take == 0:
                    hist += est(exchange.shard_batch(mesh, codes)).cpu().numpy()
        T = cfg.num_partition_tasks or n
        owner_map = (partitioner.lpt_owner_map(hist, T, cfg.b) % n).astype(np.int32)
        balance = partitioner.balance_stats(hist, owner_map, n)
    else:
        owner_map = partitioner.hash_owner_map(cfg.b, n)
        balance = {"sampled": False}

    positions = (R // n) * (L - cfg.k + 1)
    if cap is None:
        if not hist.any():
            est = exchange.estimate_bin_sizes(mesh, cfg.k, cfg.m, cfg.b)
            with fenced_span(timer, "cap_sizing", *devs):
                for codes, _sids, _, _ in batches():
                    hist += est(exchange.shard_batch(mesh, codes)).cpu().numpy()
                    break
        cap = partitioner.size_exchange_cap(hist, owner_map, n, positions)

    acc_cap = 1 << max(14, (2 * n * cap - 1).bit_length())
    ctr = stream.DistributedCounter(
        mesh, cfg.k, cfg.m, cfg.b, cap, acc_cap, owner_map, with_seq=True,
        unique_ub=unique_ub, prededup=prededup,
    )
    ckpt = None
    skip = 0
    if checkpoint_dir:
        ckpt = manifest_mod.BatchCheckpointer(checkpoint_dir, checkpoint_interval)
        skip = ckpt.completed_batches()
        ctr.host_spills.extend(ckpt.load_parts())

    n_batches = 0
    with fenced_span(timer, "count", *devs):
        for i, (codes, sids, nr, nb) in enumerate(prefetched(batches())):
            n_batches += 1
            if i < skip:
                continue  # counted before the interruption (names rebuilt)
            ctr.feed(codes, n_reads=nr, n_bases=nb, seq_ids=sids)
            if ckpt is not None and (i + 1) % ckpt.interval == 0:
                ctr.spill()
                ckpt.save_spills(i + 1, ctr.host_spills)

    with fenced_span(timer, "merge", *devs):
        words_ext, counts, bins = ctr.finalize()
    words = words_ext[:, :W]
    seqs = words_ext[:, W].astype(np.int32)

    with timer.span("distances"):
        pair_dist = pair_distances(words, seqs, counts, tags.names, measure)
    if cfg.write:
        with timer.span("write_output"):
            _write_multiseq_output(cfg, words, counts, bins, pair_dist, measure,
                                   keep_table=keep_table, timer=timer, device=devs[0])
    if ckpt is not None:
        ckpt.clear()  # the run completed
    return MultiseqResult(
        words, seqs, counts, bins, tags.names, pair_dist, int(counts.sum()),
        timer.as_dict(), exchange_bytes=ctr.exchange_bytes, balance=balance,
        n_batches=n_batches,
    )
