"""High-level Python API — the port of ``fastkmer_tpu.api`` (single device)."""

from __future__ import annotations

import numpy as np

from fastkmer_tpu.config import JobConfig
from fastkmer_tpu.core import bits
from fastkmer_tpu.output import manifest

from .pipeline import CountResult, execute_job


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
    device="cuda",
    **kw,
) -> CountResult:
    """Count canonical k-mers in a FASTA/FASTQ file on ``device``.  Writes
    per-bin files only when output_directory is given.

    ``unique_ub``: asserted bound on distinct k-mers (e.g. genome length)
    -> sync-free device accumulation, verified at finalize.
    ``prededup``: per-batch pre-dedup for duplication-heavy inputs (None =
    adaptive probing)."""
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
        cfg, verbose=False, unique_ub=unique_ub, prededup=prededup, device=device
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
