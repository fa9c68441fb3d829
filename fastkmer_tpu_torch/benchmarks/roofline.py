"""Roofline: the per-call floor, elementwise device-memory rate, sorts, and
the accumulator merge at its real shape.

The port of ``benchmarks/roofline.py``.  Every time is a slope of the host
clock: I and 2I calls, each run fenced, (T(2I) - T(I)) / I a call, so the
fence, the launch queue and the first call's build cancel.  Sections:

* ``per_call_overhead``: x + 1 on 2^10 int32 values;
* ``elementwise_2col_2^lg`` at 2^24, 2^26 and 2^28: x + y + 1 on two int32
  lanes, with its GB/s at the JAX probe's 12 bytes a value (two lanes read,
  one written: what XLA's one fused pass moves).  Eager torch runs it as two
  kernels, which move 20 bytes a value;
* ``sort_1op``, ``sort_2op``, ``sort_2key_1val`` at 2^24 and 2^26: the
  port's sorts, ``torch.sort`` of the packed int64 key of one or two uint32
  lanes, then gathers of the carried lane;
* ``merge``: ``count_sort.count_presentineled`` + ``compact_marked`` at the
  k=28 streaming merge shape (8 batches of 4096 x 4069 positions and a
  2^24-row accumulator, rounded up to 2^16 rows: 150,142,976 rows of 2 keys
  and a weight), and the sort alone at the same shape.

    python -m fastkmer_tpu_torch.benchmarks.roofline [all|quick|merge] [--device cuda|cpu]

``quick`` takes the small sizes only, ``merge`` only the merge section.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import count_sort
from ..pipeline import resolve_device
from ._common import device_name, emit, rand_i32, slope

K_POS = 4096 * (4096 - 28 + 1)  # window starts of one 4096 x 4096 batch at k=28
MERGE_ROWS = -(-(8 * K_POS + (1 << 24)) // (1 << 16)) * (1 << 16)
MERGE_CAP = 1 << 24


def merge_full(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, block_sort: bool = False,
               block: int = 8192) -> tuple:
    """The accumulator's merge as ``pipeline._acc_merge`` runs it: weighted
    count of the 2-key rows, then the compaction to MERGE_CAP rows."""
    sc = count_sort.count_presentineled([a, b], weights=w)
    return count_sort.compact_marked((sc.words[:, 0], sc.words[:, 1]), sc.counts, sc.is_uniq,
                                     MERGE_CAP, block=block, block_sort=block_sort)


def merge_section(gen: torch.Generator, dev: torch.device, rows: int = MERGE_ROWS) -> list:
    """merge_full and the sort alone at ``rows`` rows."""
    name = device_name(dev)
    a, b, w = rand_i32(gen, rows, dev), rand_i32(gen, rows, dev), rand_i32(gen, rows, dev, 1, 3)
    per, naive = slope(merge_full, (a, b, w), dev, iters=3)
    out = [emit(measure="merge_full_151M", device=name, marginal_s=per, naive_s=naive,
                rows=rows)]
    per, naive = slope(lambda x, y, z: count_sort.sort_columns([x, y], (z,)), (a, b, w), dev,
                       iters=3)
    out.append(emit(measure="merge_sort_only_151M", device=name, marginal_s=per,
                    naive_s=naive, rows=rows))
    return out


def run(stage: str = "all", device="cuda", sizes=(24, 26, 28), sort_sizes=(24, 26),
        merge_rows: int = MERGE_ROWS) -> list[dict]:
    """The sections ``stage`` names; ``quick`` keeps the two smallest sizes
    of the elementwise pass and the smallest sort."""
    dev = resolve_device(device)
    name = device_name(dev)
    gen = torch.Generator(dev).manual_seed(0)
    if stage == "merge":
        return merge_section(gen, dev, merge_rows)
    if stage == "quick":
        sizes, sort_sizes = sizes[:2], sort_sizes[:1]
    out = []
    tiny = rand_i32(gen, 1 << 10, dev)
    per, naive = slope(lambda x: x + 1, (tiny,), dev, iters=20)
    out.append(emit(measure="per_call_overhead", device=name, marginal_ms=per * 1e3,
                    naive_ms=naive * 1e3))

    for lg in sizes:  # two lanes read, one written: 12 bytes a value
        N = 1 << lg
        a, b = rand_i32(gen, N, dev), rand_i32(gen, N, dev)
        iters = max(4, min(40, (1 << 28) // N * 4))
        per, naive = slope(lambda x, y: x + y + 1, (a, b), dev, iters=iters)
        out.append(emit(measure=f"elementwise_2col_2^{lg}", device=name,
                        marginal_ms=per * 1e3, naive_ms=naive * 1e3, GBps=12 * N / per / 1e9,
                        iters=iters))
        del a, b

    for lg in sort_sizes:
        N = 1 << lg
        a, b, c = rand_i32(gen, N, dev), rand_i32(gen, N, dev), rand_i32(gen, N, dev)
        iters = max(3, min(12, (1 << 26) // N * 6))
        for arm, fn, args in (
            ("sort_1op", lambda x: count_sort.sort_columns([x]), (a,)),
            ("sort_2op", lambda x, y: count_sort.sort_columns([x, y]), (a, b)),
            ("sort_2key_1val", lambda x, y, z: count_sort.sort_columns([x, y], (z,)),
             (a, b, c)),
        ):
            per, naive = slope(fn, args, dev, iters=iters)
            out.append(emit(measure=f"{arm}_2^{lg}", device=name, marginal_ms=per * 1e3,
                            naive_ms=naive * 1e3, ns_per_elem=per * 1e9 / N, iters=iters))
        del a, b, c

    if stage != "quick":
        out += merge_section(gen, dev, merge_rows)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("stage", nargs="?", default="all", choices=("all", "quick", "merge"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.stage, args.device)


if __name__ == "__main__":
    main()
