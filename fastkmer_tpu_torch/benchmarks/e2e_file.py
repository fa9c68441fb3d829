"""The count job from a file on disk to its output, in the spill regime.

The port of ``benchmarks/e2e_file.py``.  It writes a FASTA of 4000-base
reads sampled from one 16,777,216-base random genome (``gbp`` billion
bases, default 1.0), then measures:

* the native parse and encode of the whole file (Mbp/s);
* ingest to [R, L] batches (parse, k-1 chunking, dense pack; Mbp/s);
* ``execute_job`` in the spill regime: 2048 x 4096 batches size the
  accumulator to 2^24 rows, about the genome's distinct count, so the table
  spills to the host as it fills; write=1;
* ``execute_job`` with ``unique_ub`` = the genome: the sync-free feed, no
  spill.

    python -m fastkmer_tpu_torch.benchmarks.e2e_file [gbp] [--keep] [--device cuda|cpu]

prints one JSON line per measure (wall seconds, Gbp/s, host spills, stage
spans).  On the CPU pass a small ``gbp`` (e.g. 0.002).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from .. import pipeline
from ..config import JobConfig
from ..ingest import batch as ingest_batch
from ..ingest import native as ingest_native
from ..pipeline import resolve_device
from ._common import device_name, emit, log

GENOME = 1 << 24
READ_LEN = 4000
K, M, B = 28, 10, 512


def gen_fasta(path: str, gbp: float, rng) -> int:
    """Reads sampled from one fixed random genome; returns the bases."""
    genome = rng.integers(0, 4, size=GENOME + READ_LEN, dtype=np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n_reads = max(1, int(gbp * 1e9 / READ_LEN))
    with open(path, "wb") as f:
        for base in range(0, n_reads, 4096):
            cnt = min(4096, n_reads - base)
            starts = rng.integers(0, GENOME, size=cnt)
            recs = np.empty((cnt, READ_LEN + 4), np.uint8)
            recs[:, :3] = np.frombuffer(b">r\n", np.uint8)
            recs[:, 3:-1] = acgt[genome[starts[:, None] + np.arange(READ_LEN)]]
            recs[:, -1] = ord("\n")
            recs.tofile(f)
    return n_reads * READ_LEN


def run(gbp: float = 1.0, device="cuda", keep: bool = False) -> list:
    dev = resolve_device(device)
    work = tempfile.mkdtemp(prefix="fk_e2e_")
    fa = os.path.join(work, "reads.fa")
    t0 = time.perf_counter()
    total = gen_fasta(fa, gbp, np.random.default_rng(0))
    log(f"generated {total / 1e6:.0f} Mbp in {time.perf_counter() - t0:.1f} s at {fa}")
    lines = []
    if not ingest_native.available():
        raise RuntimeError("the native ingest library (ingest/native/fkingest.cpp) failed to build")
    t0 = time.perf_counter()
    codes, starts = ingest_native.parse_file(fa, "fasta")
    dt = time.perf_counter() - t0
    lines.append(emit(probe="e2e_file", measure="native_parse_encode", device=device_name(dev),
                      mbp_per_s=total / dt / 1e6, wall_s=dt, records=int(starts.shape[0] - 1)))
    del codes, starts
    t0 = time.perf_counter()
    nb = 0
    for _, _, b in ingest_batch.batch_file(fa, 0, K, 4096, 4096):
        nb += b
    dt = time.perf_counter() - t0
    lines.append(emit(probe="e2e_file", measure="ingest_to_batches", device=device_name(dev),
                      mbp_per_s=nb / dt / 1e6, wall_s=dt, bases=nb))
    spills = []
    real_spill = pipeline.DeviceAccumulator._spill

    def counting_spill(acc, stats):
        if stats["n_unique"]:
            spills.append(stats["n_unique"])
        return real_spill(acc, stats)

    pipeline.DeviceAccumulator._spill = counting_spill
    try:
        for name, ub in (("spill_regime", None), ("asserted_ub", GENOME)):
            spills.clear()
            cfg = JobConfig(dataset=fa, output_directory=work + "/", prefix=f"{name}_", k=K,
                            m=M, max_b=B, write=True, reads_per_batch=2048, read_len=4096)
            t0 = time.perf_counter()
            res = pipeline.execute_job(cfg, verbose=False, unique_ub=ub, device=dev)
            dt = time.perf_counter() - t0
            # the last entry is finalize's pull of the live table
            lines.append(emit(probe="e2e_file", measure=f"execute_job_{name}",
                              device=device_name(dev), wall_s=dt, gbp_per_s=res.n_bases / dt / 1e9,
                              host_spills=max(len(spills) - 1, 0), uniques=int(res.words.shape[0]),
                              n_batches=res.n_batches, stage_s=res.timings))
            shutil.rmtree(cfg.output_dir)
    finally:
        pipeline.DeviceAccumulator._spill = real_spill
    if keep:
        log(f"kept {work}")
    else:
        shutil.rmtree(work)
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("gbp", nargs="?", type=float, default=1.0)
    p.add_argument("--keep", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.gbp, args.device, args.keep)


if __name__ == "__main__":
    main()
