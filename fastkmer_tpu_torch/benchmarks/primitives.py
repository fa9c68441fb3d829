"""The library primitives that bound the counting pipeline, timed on the
card: the yardsticks later redesigns of kernels C and D are held against.

The port of ``benchmarks/primitives.py``: at N = 2^lg (default 2^24) the
port's sorts of one, two, and two + one carried uint32 lanes
(``torch.sort`` of the packed int64 key, then gathers), a random gather,
``torch.searchsorted`` of N queries in N sorted values, an int32
``torch.cumsum``, and the merge-path step (rank in sorted values, then a
gather).  Each is the mean of five fenced calls by the host clock, after
two warm-up calls.

    python -m fastkmer_tpu_torch.benchmarks.primitives [lg] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core.tbits import as_u32
from ..ops import count_sort
from ..pipeline import resolve_device
from ._common import device_name, emit, fence, rand_i32


def timeit(fn, args: tuple, dev: torch.device, iters: int = 5, warmup: int = 2) -> float:
    """Mean seconds a call over ``iters`` calls, fenced once at the end."""
    for _ in range(warmup):
        fn(*args)
    fence(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    fence(dev)
    return (time.perf_counter() - t0) / iters


def run(lg: int = 24, device="cuda") -> list[dict]:
    dev = resolve_device(device)
    N = 1 << lg
    gen = torch.Generator(dev).manual_seed(0)
    a, b, c = rand_i32(gen, N, dev), rand_i32(gen, N, dev), rand_i32(gen, N, dev)
    srt = torch.sort(as_u32(rand_i32(gen, N, dev))).values  # uint32 values, in int64
    idx = rand_i32(gen, N, dev, 0, N).to(torch.int64)

    def merge_rank(s, q, v):
        r = torch.searchsorted(s, as_u32(q))
        return v[torch.clamp(r, max=N - 1)]

    prims = (
        ("sort_1op", lambda x: count_sort.sort_columns([x]), (a,)),
        ("sort_2op", lambda x, y: count_sort.sort_columns([x, y]), (a, b)),
        ("sort_2key_1val", lambda x, y, z: count_sort.sort_columns([x, y], (z,)), (a, b, c)),
        ("gather", lambda x, i: x[i], (a, idx)),
        ("searchsorted", lambda s, q: torch.searchsorted(s, as_u32(q)), (srt, a)),
        ("cumsum", lambda x: torch.cumsum(x, 0, dtype=torch.int32), (a,)),
        ("searchsorted_gather", merge_rank, (srt, a, b)),
    )
    out = []
    name = device_name(dev)
    for prim, fn, args in prims:
        t = timeit(fn, args, dev)
        out.append(emit(primitive=f"{prim}_2^{lg}", device=name, ms=t * 1e3,
                        ns_per_elem=t * 1e9 / N))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("lg", nargs="?", type=int, default=24, help="log2 of the values")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.lg, args.device)


if __name__ == "__main__":
    main()
