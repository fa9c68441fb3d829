"""Where the single-device streaming loop's wall time goes.

The port of ``benchmarks/stream_probe.py``: 8 batches of [4096, 4096]
reads of a 2^24-base random genome.  It reports the host seconds to queue
the copies to the device and to land them; one fenced kernel-A extract
(``pipeline._batch_extract_keys``, after a warm-up); then two reps of 8
``add_raw`` dispatches into a fresh accumulator (fan-in 8, so the eighth
dispatch queues the merge), each dispatch's host seconds, the host seconds
of the whole feed and of the fence (the stats read) after it.  A dispatch
that returns long before the fence has only queued its work.

    python -m fastkmer_tpu_torch.benchmarks.stream_probe [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import bench, pipeline
from ._common import device_name, emit, fence


def run(R: int = bench.R, L: int = bench.L, genome: int = bench.GENOME, n_batch: int = 8,
        device="cuda") -> dict:
    dev = pipeline.resolve_device(device)
    k, m, b = bench.K, bench.M, bench.B
    rng = np.random.default_rng(0)
    g = rng.integers(0, 4, size=genome + L, dtype=np.uint8)
    host = [g[rng.integers(0, genome, size=R)[:, None] + np.arange(L)[None, :]]
            for _ in range(n_batch)]
    t = time.perf_counter()
    staged = [torch.from_numpy(h).to(dev, non_blocking=True) for h in host]
    put_s = time.perf_counter() - t
    t = time.perf_counter()
    fence(dev)
    land_s = time.perf_counter() - t

    cols = pipeline._batch_extract_keys(staged[0], k, m, b)
    fence(dev)
    t = time.perf_counter()
    cols = pipeline._batch_extract_keys(staged[1 % n_batch], k, m, b)
    fence(dev)
    extract_s = time.perf_counter() - t
    del cols

    reps = []
    for _ in range(2):
        acc = pipeline.DeviceAccumulator(k, fanin=n_batch, m=m, B=b, unique_ub=genome,
                                         device=dev)
        t0 = time.perf_counter()
        disp = []
        for codes in staged:
            t = time.perf_counter()
            acc.add_raw(pipeline._batch_extract_keys(codes, k, m, b))
            disp.append(time.perf_counter() - t)
        feed_s = time.perf_counter() - t0  # the last add_raw queued the merge
        t = time.perf_counter()
        stats = acc.check()
        fence_s = time.perf_counter() - t
        reps.append({"feed_s": feed_s, "dispatch_s": disp, "fence_s": fence_s,
                     "total_s": feed_s + fence_s, "n_unique": stats["n_unique"]})
    return emit(probe="stream", batches=n_batch, rows=R, read_len=L, genome=genome,
                device=device_name(dev), put_s=put_s, land_s=land_s,
                extract_fenced_s=extract_s, reps=reps)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    run(device=p.parse_args(argv).device)


if __name__ == "__main__":
    main()
