"""The accumulator merge with its default compaction against the block-sort
route (kernel C), at the real merge shape.

The port of ``benchmarks/compact_probe.py``.  ``roofline.merge_full``
(``count_presentineled`` + ``compact_marked``) with the prefix-sum scatter
(``default``) or the block sort (``block_sort``, ``cuda_sort.sort_blocks_``
on the card) at 150,142,976 rows; first the two routes' exactness at 2^22
rows (tie-heavy keys): every output lane, n_u and the overflow equal.

    python -m fastkmer_tpu_torch.benchmarks.compact_probe [quick|blocks] [--device cuda|cpu]

``quick`` stops after the exactness line; ``blocks`` times the block sort at
blocks of 2^15 and 2^16 and the default at 2^15 instead of both at 8192.
"""

from __future__ import annotations

import argparse

import torch

from ..pipeline import resolve_device
from ._common import device_name, emit, rand_i32, slope
from .roofline import MERGE_ROWS, merge_full

EXACT_ROWS = 1 << 22


def exactness(gen: torch.Generator, dev: torch.device, rows: int = EXACT_ROWS) -> dict:
    a = rand_i32(gen, rows, dev, 0, 1 << 22)
    b = rand_i32(gen, rows, dev, 0, 1 << 8) << 8
    w = rand_i32(gen, rows, dev, 1, 3)
    ref = merge_full(a, b, w)
    got = merge_full(a, b, w, block_sort=True)
    ok = (all(torch.equal(r, g) for r, g in zip(ref[0], got[0]))
          and torch.equal(ref[1], got[1])
          and int(ref[2]) == int(got[2]) and int(ref[3]) == int(got[3]))
    lg = rows.bit_length() - 1
    return emit(measure=f"hw_merge_exactness_2^{lg}", device=device_name(dev), ok=bool(ok),
                n_u=int(ref[2]))


def run(mode: str = "all", device="cuda", rows: int = MERGE_ROWS,
        exact_rows: int = EXACT_ROWS) -> list[dict]:
    """The exactness line, then (unless ``quick``, and if it holds) one line
    per (route, block)."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    out = [exactness(gen, dev, exact_rows)]
    if not out[0]["ok"] or mode == "quick":
        return out
    a, b, w = rand_i32(gen, rows, dev), rand_i32(gen, rows, dev), rand_i32(gen, rows, dev, 1, 3)
    variants = [("default", False, 8192), ("block_sort", True, 8192)]
    if mode == "blocks":
        variants = [("block_sort", True, 1 << 15), ("block_sort", True, 1 << 16),
                    ("default", False, 1 << 15)]
    for route, block_sort, block in variants:
        per, _ = slope(lambda x, y, z: merge_full(x, y, z, block_sort, block), (a, b, w), dev,
                       iters=3)
        out.append(emit(measure=f"merge_full_151M_{route}_b{block}", device=device_name(dev),
                        marginal_s=per, rows=rows))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default="all", choices=("all", "quick", "blocks"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.mode, args.device)


if __name__ == "__main__":
    main()
