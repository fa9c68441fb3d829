"""High-level Python API — the port of ``fastkmer_tpu.api``."""

from __future__ import annotations

import numpy as np
import torch

from .config import JobConfig
from .core import bits
from .output import manifest
from .pipeline import CountResult, execute_job, resolve_device


def count_kmers(
    dataset: str,
    k: int = 28,
    m: int = 10,
    bins: int = 2000,
    sequence_type: int = 0,
    use_ht: bool = False,
    output_directory: str | None = None,
    unique_ub: int | None = None,
    prededup: bool | None = None,
    checkpoint_dir: str | None = None,
    device="cuda",
    checkpoint_interval: int = 32,
    keep_table: bool = False,
    **kw,
) -> CountResult:
    """Count canonical k-mers in a FASTA/FASTQ file on ``device``.  Writes
    per-bin files only when output_directory is given.

    ``unique_ub``: asserted bound on distinct k-mers (e.g. genome length)
    -> sync-free device accumulation, verified at finalize.
    ``prededup``: per-batch pre-dedup for duplication-heavy inputs (None =
    adaptive probing).  ``checkpoint_dir``: kill-and-resume, a checkpoint
    every ``checkpoint_interval`` batches.  ``keep_table``: write the
    table.npz sidecar for a repair without recount."""
    cfg = JobConfig(
        dataset=dataset,
        output_directory=output_directory or "",
        k=k,
        m=m,
        max_b=bins,
        sequence_type=sequence_type,
        use_ht=use_ht,
        write=output_directory is not None,
        **kw,
    )
    return execute_job(
        cfg, verbose=False, unique_ub=unique_ub, prededup=prededup,
        checkpoint_dir=checkpoint_dir, device=device,
        checkpoint_interval=checkpoint_interval, keep_table=keep_table,
    )


def count_kmers_distributed(
    dataset: str,
    n_devices: int | None = None,
    k: int = 28,
    m: int = 10,
    bins: int = 2000,
    sequence_type: int = 0,
    use_ht: bool = False,
    output_directory: str | None = None,
    unique_ub: int | None = None,
    prededup: bool | None = None,
    use_custom_partitioner: bool = False,
    checkpoint_dir: str | None = None,
    device="cuda",
    streaming: bool | None = None,
    checkpoint_interval: int = 32,
    keep_table: bool = False,
    **kw,
):
    """Count canonical k-mers over a mesh of ``n_devices`` shards (the
    library form of the ``--mesh`` CLI).

    ``n_devices`` defaults to the visible CUDA devices (1 on the CPU); on
    CUDA shard i lives on ``cuda:{i % device_count()}``.  Under an
    initialized process group of p > 1 ranks (``parallel.multihost``)
    ``n_devices`` is the global shard count (default p), n_devices / p on
    each rank's device; each rank gets its own shards' table and writes
    its own bins.  ``streaming``
    None/True runs the streaming counter (tables stay on the devices across
    batches); ``streaming=False`` the per-batch k-mer transport.
    ``prededup``: the streaming counter's dedup transport (None adaptive).
    ``use_custom_partitioner``: sampled LPT bin placement.
    ``checkpoint_dir``, ``checkpoint_interval`` and ``keep_table`` as in
    count_kmers.  Returns ``parallel.driver.DistributedResult``."""
    from .parallel import driver, multihost

    dev = resolve_device(device)
    p = multihost.world_size()
    if n_devices is None:
        n_devices = p if p > 1 else (torch.cuda.device_count() if dev.type == "cuda" else 1)
    if n_devices % p:
        raise ValueError(f"{n_devices} shards do not split over {p} ranks")
    mesh = multihost.init_global_mesh(n_devices // p, dev)
    cfg = JobConfig(
        dataset=dataset,
        output_directory=output_directory or "",
        k=k,
        m=m,
        max_b=bins,
        sequence_type=sequence_type,
        use_ht=use_ht,
        write=output_directory is not None,
        use_custom_partitioner=use_custom_partitioner,
        **kw,
    )
    return driver.execute_job_distributed(
        cfg, mesh, verbose=False, unique_ub=unique_ub, prededup=prededup,
        checkpoint_dir=checkpoint_dir, streaming=streaming,
        checkpoint_interval=checkpoint_interval, keep_table=keep_table,
    )


def verify_output(output_dir: str) -> dict:
    """Check a written output directory against its manifest (sha256 of
    every bin file or npz artifact).  Returns {ok, missing, mismatched,
    extra_missing, extra_mismatched}."""
    return manifest.verify_output(output_dir)


def spectrum(res: CountResult, max_count: int = 10000) -> np.ndarray:
    """k-mer spectrum: spectrum[c] = number of distinct k-mers with count c
    (counts above max_count are clamped into the last bucket)."""
    if res.counts.size == 0:
        return np.zeros(max_count + 1, np.int64)
    return np.bincount(
        np.minimum(res.counts, max_count).astype(np.int64), minlength=max_count + 1
    )


def stats(res: CountResult) -> dict:
    """Summary statistics of a count table."""
    c = res.counts
    return {
        "total_kmers": int(c.sum()),
        "distinct_kmers": int(c.size),
        "unique_kmers": int((c == 1).sum()),  # singletons
        "max_count": int(c.max()) if c.size else 0,
        "mean_count": float(c.mean()) if c.size else 0.0,
        "n_reads": res.n_reads,
        "n_bases": res.n_bases,
    }


def to_dict(res: CountResult, k: int) -> dict[str, int]:
    """Count table as {kmer_string: count} (host memory scales with U)."""
    kmers = bits.decode_words_batch(res.words, k)
    return {km.decode(): int(c) for km, c in zip(kmers, res.counts.tolist())}


def dump(res: CountResult, k: int, path: str) -> None:
    """Single-file sorted ``<KMER>\\t<count>`` dump."""
    with open(path, "wb") as f:
        kmers = bits.decode_words_batch(res.words, k)
        for km, c in zip(kmers, res.counts.tolist()):
            f.write(km + b"\t" + str(int(c)).encode() + b"\n")


def load_binary(path: str) -> CountResult:
    """Load a binary (npz) output written with use_kryo_serializer=1."""
    with np.load(path) as z:
        words, counts, bins = z["words"], z["counts"], z["bins"]
    return CountResult(
        words=words, counts=counts, bins=bins, n_instances=int(counts.sum()),
        n_bases=0, n_reads=0, n_batches=0, timings={}, spans=[], counters={},
    )
