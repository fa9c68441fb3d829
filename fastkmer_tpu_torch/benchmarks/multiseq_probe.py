"""Multiseq's accumulator against plain counting, on one device.

The port of ``benchmarks/multiseq_probe.py``.  S random genomes of G bases;
NB batches of [R, L] codes, each row a window of one genome with a random
sequence id, staged on the device beforehand.  Each arm feeds the batches
to a ``DeviceAccumulator`` (fan-in NB, ``unique_ub`` = S·G + NB·R) and
merges them once: "plain" with kernel A's key lanes (the count job's stage
1), "multiseq" with the seq lane appended (``_batch_extract_keys_seq``, one
more key lane through every merge).

    python -m fastkmer_tpu_torch.benchmarks.multiseq_probe [--seqs 8] [--genome 2097152]
        [--batches 8] [--rows 4096] [--len 4096] [--device cuda|cpu]

prints one JSON line per arm (seconds of the warm second run by the host
clock, fenced; Gbp/s; distinct keys; kernel A launches) and one with the
ratio.  On the CPU pass small shapes (e.g. --genome 4096 --rows 64 --len 256).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import pipeline
from ..multiseq.pipeline import _batch_extract_keys_seq
from ..ops import cuda_extract
from ..pipeline import resolve_device
from ._common import device_name, emit, fence, log

K, M, B = 28, 10, 512


def stage(rng, S: int, G: int, NB: int, R: int, L: int, dev: torch.device) -> list:
    """NB (codes [R, L] uint8, sids [R] int32) on ``dev``: row r is a window
    of genome sids[r]."""
    genomes = [rng.integers(0, 4, size=G + L, dtype=np.uint8) for _ in range(S)]
    staged = []
    for _ in range(NB):
        sids = rng.integers(0, S, size=R).astype(np.int32)
        codes = np.empty((R, L), np.uint8)
        for s in range(S):
            rows = np.flatnonzero(sids == s)
            starts = rng.integers(0, G, size=rows.size)
            codes[rows] = genomes[s][starts[:, None] + np.arange(L)[None, :]]
        staged.append((torch.from_numpy(codes).to(dev), torch.from_numpy(sids).to(dev)))
    return staged


def run(S: int = 8, G: int = 1 << 21, NB: int = 8, R: int = 4096, L: int = 4096,
        device="cuda", seed: int = 0) -> list:
    dev = resolve_device(device)
    staged = stage(np.random.default_rng(seed), S, G, NB, R, L, dev)

    def count(with_seq: bool) -> dict:
        acc = pipeline.DeviceAccumulator(K, fanin=NB, m=M, B=B, unique_ub=S * G + NB * R,
                                         extra_lanes=1 if with_seq else 0, device=dev)
        for codes, sids in staged:
            if with_seq:
                acc.add_raw(_batch_extract_keys_seq(codes, sids, K, M, B))
            else:
                acc.add_raw(pipeline._batch_extract_keys(codes, K, M, B))
        return acc.check()

    lines, secs = [], {}
    for arm, with_seq in (("plain", False), ("multiseq", True)):
        count(with_seq)  # warm-up: builds the kernel, fills the allocator
        fence(dev)
        cuda_extract.LAUNCHES = 0
        t0 = time.perf_counter()
        stats = count(with_seq)
        fence(dev)
        secs[arm] = time.perf_counter() - t0
        log(f"{arm}: {secs[arm]:.4f} s, {stats['n_unique']} distinct")
        lines.append(emit(probe="multiseq_probe", device=device_name(dev), arm=arm, k=K,
                          seqs=S, genome=G, batches=NB, rows=R, read_len=L,
                          seconds=secs[arm], gbps=NB * R * L / secs[arm] / 1e9,
                          n_unique=stats["n_unique"], extract_launches=cuda_extract.LAUNCHES))
    lines.append(emit(probe="multiseq_probe", device=device_name(dev),
                      multiseq_over_plain=secs["multiseq"] / secs["plain"]))
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seqs", type=int, default=8)
    p.add_argument("--genome", type=int, default=1 << 21)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--len", type=int, default=4096)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(a.seqs, a.genome, a.batches, a.rows, a.len, a.device)


if __name__ == "__main__":
    main()
