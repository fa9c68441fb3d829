"""Skew-aware bin -> shard placement — the port's copy of
``fastkmer_tpu.parallel.partitioner``.

Re-implementation of the reference's LPT partitioner
(``MultiprocessorSchedulingPartitioner``,
src/main/scala/skc/MultiprocessorSchedulingPartitioner.scala:11-69):

* items (bin, estimated k-mer count) are taken in DESCENDING size order
  (the caller sorts, reference SparkBinKmerCounter.scala:1024);
* each is assigned to the currently least-loaded of ``n_parts`` task bins
  (``findBinLPT``, :63-65);
* final partition ids go through a fixed-seed (31337) permutation to
  decorrelate placement (:45, :55);
* bins unseen in the sample fall back to ``nonNegativeMod(bin, n_parts)``
  (:27-30) — here simply ``bin % n_parts`` since bin ids are non-negative.

Where the reference returns a Spark ``Partitioner``, this returns a dense
``int32[B]`` owner table that the exchange step indexes on the device —
the device-side analogue of a partitioner object.
"""

from __future__ import annotations

import numpy as np


def lpt_owner_map(bin_sizes: np.ndarray, n_parts: int, B: int | None = None) -> np.ndarray:
    """bin_sizes: int array [B] of estimated k-mer counts per bin (0 = unseen).

    Returns int32[B] owner table mapping each bin to a partition/chip.
    """
    bin_sizes = np.asarray(bin_sizes)
    B = B if B is not None else bin_sizes.shape[0]
    owners = (np.arange(B, dtype=np.int64) % n_parts).astype(np.int32)  # hash fallback
    seen = np.flatnonzero(bin_sizes > 0)
    if seen.size:
        order = seen[np.argsort(-bin_sizes[seen], kind="stable")]  # descending LPT order
        loads = np.zeros(n_parts, dtype=np.int64)
        perm = np.random.RandomState(31337).permutation(n_parts).astype(np.int32)
        for b in order.tolist():
            tgt = int(np.argmin(loads))
            loads[tgt] += int(bin_sizes[b])
            owners[b] = perm[tgt]
    return owners


def hash_owner_map(B: int, n_parts: int) -> np.ndarray:
    """Default ownership when no pre-pass ran (the reference's plain
    ``reduceByKey`` hash partitioning, SparkBinKmerCounter.scala:1035)."""
    return (np.arange(B, dtype=np.int64) % n_parts).astype(np.int32)


def size_exchange_cap(
    bin_sizes: np.ndarray,
    owners: np.ndarray,
    n_parts: int,
    positions: int,
    slack: float = 2.0,
    floor: int = 4096,
    granule: int = 1024,
) -> int:
    """Per-(src,dst) all_to_all lane capacity from the sampled histogram.

    The reference computes an extraction-time per-bin k-mer upper bound to
    size its reduce-side tables (``getSuperKmersWithBinSizes``,
    SparkBinKmerCounter.scala:290-426); the TPU analogue sizes the exchange
    buffers: a chip extracting ``positions`` k-mers per batch sends about
    ``positions * load_share(dst)`` entries to each destination, so the
    capacity is the maximum owner share times a slack factor.  Overflow is
    detected (psum'd dropped counter) and retried at doubled capacity, so
    ``slack`` trades exchange bytes against rare retries; the result is
    clipped to the worst case (= ``positions``, every entry to one owner).
    """
    bin_sizes = np.asarray(bin_sizes, dtype=np.int64)
    total = int(bin_sizes.sum())
    if total <= 0:
        return positions  # no sample available: worst case
    loads = np.zeros(n_parts, dtype=np.int64)
    np.add.at(loads, np.asarray(owners)[: bin_sizes.shape[0]], bin_sizes)
    share = loads.max() / total
    cap = int(np.ceil(positions * share * slack))
    cap = max(cap, floor)
    cap = -(-cap // granule) * granule
    return min(cap, positions)


def balance_stats(bin_sizes: np.ndarray, owners: np.ndarray, n_parts: int) -> dict:
    """Per-partition load summary — the structured replacement for the
    reference's ``evaluatePartitionBalance`` debug dump
    (SparkBinKmerCounter.scala:742-767)."""
    loads = np.zeros(n_parts, dtype=np.int64)
    np.add.at(loads, owners, np.asarray(bin_sizes, dtype=np.int64))
    total = int(loads.sum())
    mx = int(loads.max()) if n_parts else 0
    return {
        "loads": loads.tolist(),
        "total": total,
        "max": mx,
        "imbalance": (mx * n_parts / total) if total else 1.0,
    }
