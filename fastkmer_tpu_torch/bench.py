"""Synthetic bench of the port: streaming k-mer counting on one card.

The port of the repository's ``bench.py`` with its workload unchanged:
k=28 m=10 B=512, 16 batches of [4096, 4096] reads, each read a random
substring of a 2^24-base random genome (about 16x coverage, so distinct
k-mers are bounded by the genome), the accumulator's fan-in from
``FASTKMER_BENCH_FANIN`` (default 16) and ``unique_ub`` = the genome size.
The batches are staged on the card and landed before the clock starts;
one warm-up replays the exact timed sequence; the one fence is the
accumulator's ``check`` after its last part, plus a synchronize.

Modes (argv[1], each with bench.py's metric name):

* ``stream`` (default): kernel A into ``DeviceAccumulator.add_raw``, with
  the dedup probe (``_batch_count_dedup``) every 16th batch, whose raw
  columns are admitted as the adaptive controller does on an overflow; the
  line also carries ``extra.step_gbps``, the ``step`` mode's number;
* ``step``: the per-batch count alone (kernel A + ``count_presentineled``);
* ``percount``: the per-batch count into ``DeviceAccumulator.add``;
* ``dedup``: ``_batch_count_dedup`` into ``add_part``; no compaction may
  overflow, so it needs the dup workload (on the 2^24 genome a batch's
  distinct rows outgrow the npos / 4 capacity and the mode raises, as
  bench.py's asserts);
* ``adaptive``, ``forced``, ``raw``: ``pipeline.count_batches`` with
  ``prededup`` None, True, False and ``device_accumulate=True``;
* argv[2] ``dup``: any mode on a 2^21-base genome (about 8x in-batch
  coverage), with ``_dup`` in the metric name.

Prints one JSON line: ``metric``, ``value`` (Gbp/s), ``unit`` and the
device it ran on.  Diagnostics go to stderr.

    python -m fastkmer_tpu_torch.bench [mode] [dup] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import pipeline
from .ops import count_sort

K, M, B = 28, 10, 512
R, L = 4096, 4096  # 16.8 Mbp a batch
GENOME = 1 << 24  # distinct k-mers bounded by the genome
DUP_GENOME = 1 << 21  # the dup workload: about 8x in-batch coverage
NBATCH = 16  # 268 Mbp, about 16x coverage
FANIN = 16
PROBE_EVERY = 16  # the adaptive controller's probe cadence (count_batches)
STEP_WARMUPS, STEP_ITERS = 2, 5  # the step line's untimed and timed counts
MODES = ("stream", "step", "percount", "dedup", "adaptive", "forced", "raw")
CONTROLLER = {"adaptive": None, "forced": True, "raw": False}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_batches(rng: np.random.Generator, R: int, L: int, n_batch: int,
                 genome: int) -> list[np.ndarray]:
    """Reads are random substrings of one random genome (bench.py's
    coverage sampling, draw for draw)."""
    g = rng.integers(0, 4, size=genome + L, dtype=np.int64).astype(np.uint8)
    out = []
    for _ in range(n_batch):
        starts = rng.integers(0, genome, size=R)
        out.append(g[starts[:, None] + np.arange(L)[None, :]])
    return out


def stage(batches: list, dev: torch.device) -> list[torch.Tensor]:
    """Host batches -> device tensors, landed before any clock starts."""
    staged = [torch.from_numpy(b).to(dev) for b in batches]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return staged


def feed(acc: pipeline.DeviceAccumulator, staged: list, mode: str) -> dict:
    """One pass of ``mode`` over ``staged`` into ``acc``, ended by the one
    fence: the last merge, the stats read and a synchronize.  -> stats
    (``n_unique``, ``overflow``; under ``stream`` and ``dedup`` also the
    dedup steps' overflows, ``pre_over``)."""
    k, m, b = acc.k, acc.m, acc.B
    pre_over = torch.zeros((), dtype=torch.int64, device=acc.device)
    for i, codes in enumerate(staged):
        dcap = pipeline._dedup_cap(codes.shape[0] * (codes.shape[1] - k + 1))
        if mode == "stream" and i % PROBE_EVERY == 0:
            # the adaptive controller's probe is a dedup attempt; at this
            # workload's distinct ratio it overflows and the batch goes in
            # as its retained raw columns, so both dispatches are timed
            _dc, _dw, _nu, over, raw_cols = pipeline._batch_count_dedup(
                codes, k, m, b, dcap)
            pre_over += over > 0
            acc.add_raw(raw_cols)
        elif mode == "percount":
            acc.add(pipeline._batch_count_sorted(codes, k, m, b))
        elif mode == "dedup":
            dcols, dwts, _nu, over, _raw = pipeline._batch_count_dedup(
                codes, k, m, b, dcap)
            pre_over += over
            acc.add_part(dcols, dwts)
        else:
            acc.add_raw(pipeline._batch_extract_keys(codes, k, m, b))
    stats = acc.check()  # a scalar read: waits for every dispatch above
    if acc.device.type == "cuda":
        torch.cuda.synchronize(acc.device)
    stats["pre_over"] = int(pre_over)
    return stats


def timed(run) -> tuple[float, object]:
    """``run()`` once as the warm-up (builds, allocator growth), then once
    on the clock -> (seconds, the timed run's result)."""
    run()
    t0 = time.perf_counter()
    out = run()
    return time.perf_counter() - t0, out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"bench sanity check failed: {msg}")


def run_stream(staged: list, mode: str, genome: int, fanin: int):
    """-> (seconds, stats, the final accumulator) of ``mode`` over the
    staged batches, with bench.py's sanity checks."""
    dev = staged[0].device
    L = staged[0].shape[1]

    def run():
        acc = pipeline.DeviceAccumulator(K, fanin=fanin, m=M, B=B, unique_ub=genome, device=dev)
        return acc, feed(acc, staged, mode)

    dt, (acc, stats) = timed(run)
    _check(stats["overflow"] == 0, f"accumulator overflow {stats}")
    if mode == "dedup":
        _check(stats["pre_over"] == 0, f"a dedup compaction overflowed {stats}")
    # distinct canonical k-mers ~ genome * (1 - exp(-coverage))
    _check(0.5 * genome < stats["n_unique"] <= genome + L, f"distinct count {stats}")
    return dt, stats, acc


def _sync_step(sc: count_sort.SortedCounts) -> None:
    """The step's fence: two small reads of its result."""
    sc.n_valid.item()
    sc.counts[:8].cpu()


def run_step(staged: list) -> float:
    """Gbp/s of the per-batch count step (kernel A + count_presentineled)
    on the first batch: STEP_WARMUPS warm-ups, then STEP_ITERS steps
    fenced once."""
    codes = staged[0]
    for _ in range(STEP_WARMUPS):
        _sync_step(pipeline._batch_count_sorted(codes, K, M, B))
    t0 = time.perf_counter()
    for _ in range(STEP_ITERS):
        sc = pipeline._batch_count_sorted(codes, K, M, B)
    _sync_step(sc)
    return codes.numel() * STEP_ITERS / (time.perf_counter() - t0) / 1e9


def run_controller(staged: list, prededup, genome: int):
    """-> (seconds, stats, CountResult) of the single-device controller,
    ``pipeline.count_batches``, on the staged batches."""
    dev = staged[0].device

    def run():
        return pipeline.count_batches(
            ((c, 0, 0) for c in staged), K, M, B, device=dev, unique_ub=genome,
            prededup=prededup, device_accumulate=True)

    dt, res = timed(run)
    return dt, {"n_unique": int(res.words.shape[0]), "overflow": 0}, res


def metric_name(mode: str, dup: bool) -> str:
    if mode == "step":
        return "count_step_throughput_k28_m10"
    name = "stream_count_throughput_k28_m10" if mode == "stream" else \
        f"stream_{mode}_throughput_k28_m10"
    return name + "_dup" if dup else name


def run(mode: str = "stream", dup: bool = False, R: int = R, L: int = L,
        n_batch: int = NBATCH, genome: int | None = None, fanin: int = FANIN,
        device="cuda") -> tuple[dict, tuple | None]:
    """One bench line for ``mode`` -> (the JSON record, the final table
    (words, counts, bins) on the host, None for ``step``).  The defaults
    are bench.py's workload; smaller sizes serve the tests."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    dev = pipeline.resolve_device(device)
    if genome is None:
        genome = DUP_GENOME if dup else GENOME
    log(f"generating and staging {n_batch} batches of [{R}, {L}] from a {genome}-base genome")
    staged = stage(make_batches(np.random.default_rng(0), R, L, n_batch, genome), dev)
    extra = None
    table = None
    if mode == "step":
        gbps = run_step(staged)
    else:
        if mode in CONTROLLER:
            dt, stats, res = run_controller(staged, CONTROLLER[mode], genome)
            table = (res.words, res.counts, res.bins)
        else:
            dt, stats, acc = run_stream(staged, mode, genome, fanin)
            table = acc.finalize()
        bases = n_batch * R * L
        gbps = bases / dt / 1e9
        log(f"{mode}: {bases / 1e6:.0f} Mbp in {dt:.4f} s, distinct {stats['n_unique']}")
        if mode == "stream" and not dup:
            # the line carries the per-batch step too, as bench.py's does
            extra = {"step_gbps": run_step(staged),
                     "note": "value = streaming count incl. every cross-batch merge; "
                             "step_gbps = the per-batch count step alone"}
    rec = {"metric": metric_name(mode, dup), "value": gbps, "unit": "Gbp/s",
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if extra:
        rec["extra"] = extra
    return rec, table


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default="stream", choices=MODES)
    p.add_argument("workload", nargs="?", default="", choices=("", "dup"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dup = args.workload == "dup"
    genome = int(os.environ.get("FASTKMER_BENCH_GENOME", DUP_GENOME if dup else GENOME))
    fanin = int(os.environ.get("FASTKMER_BENCH_FANIN", FANIN))
    rec, _ = run(args.mode, dup or genome != GENOME, genome=genome, fanin=fanin,
                 device=args.device)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
