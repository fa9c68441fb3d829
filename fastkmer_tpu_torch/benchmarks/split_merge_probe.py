"""Split sort + kernel D (bitonic merge) against one 2-key sort.

The port of ``benchmarks/split_merge_probe.py``.  The question it asks: do
two sorts of N/2 rows and a merge of the halves beat one sort of N rows?
The rows are (a, b, w): two uint32 key lanes and a weight, at N = 2^lgN
(default 2^27, the JAX probe's size for its merge window).  Three arms:

* ``single``: one 2-key sort of (a, b, w) by ``torch.sort`` of the packed
  key (``core.tbits.pair_key``), then gathers (``count_sort.sort_columns``);
* ``split``: each half sorted the same way, the second on bit-NOT keys so
  that it is descending (``cuda_bitonic_merge.bitonic_input``), then kernel
  D;
* ``merge_only``: kernel D alone, on halves already arranged.

First the arms' exactness at min(2^22, N) rows (a drawn from 2^24 values, so
keys tie), then each arm's marginal seconds a call (the slope of the host
clock) and ns a row; on the card kernel D's own ms by CUDA events too.

    python -m fastkmer_tpu_torch.benchmarks.split_merge_probe [lgN] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..ops import count_sort
from ..pipeline import resolve_device
from . import cuda_bitonic_merge as cbm
from ._common import device_name, emit, rand_i32, slope, time_ms

MERGE_BLOCK = 1 << 16  # the JAX probe's block (the TPU tile); legal from N = 2^17
EXACT_ROWS = 1 << 22


def single(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> tuple:
    """One 2-key sort of the rows (a, b, w)."""
    (sa, sb), (sw,) = count_sort.sort_columns([a, b], (w,))
    return sa, sb, sw


def split(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, block: int) -> tuple:
    """The halves sorted (the second descending), then merged by kernel D."""
    return cbm.bitonic_merge_(cbm.bitonic_input((a, b, w), 2), 2, block)


def _block(N: int) -> int:
    """The JAX probe's block, or the largest one a short N allows."""
    return min(MERGE_BLOCK, N // 2)


def exactness(gen: torch.Generator, N: int, dev: torch.device) -> dict:
    """``split`` against ``single`` on N rows whose a lane ties often: key
    lanes equal, rows the same multiset."""
    a = rand_i32(gen, N, dev, 0, 1 << 24)
    b = rand_i32(gen, N, dev)
    w = rand_i32(gen, N, dev, 1, 3)
    ref = single(a, b, w)
    got = split(a, b, w, _block(N))
    keys_ok = torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
    rows_ok = all(torch.equal(x, y) for x, y in zip(count_sort.sort_columns(list(ref))[0],
                                                    count_sort.sort_columns(list(got))[0]))
    lg = N.bit_length() - 1
    return emit(measure=f"hw_split_merge_exactness_2^{lg}", device=device_name(dev),
                keys_ok=bool(keys_ok), rows_multiset_ok=bool(rows_ok))


def run(lgN: int = 27, device="cuda") -> list[dict]:
    """The exactness line, then (if it holds) one line per arm."""
    dev = resolve_device(device)
    N = 1 << lgN
    block = _block(N)
    name = device_name(dev)
    gen = torch.Generator(dev).manual_seed(0)
    out = [exactness(gen, min(EXACT_ROWS, N), dev)]
    if not (out[0]["keys_ok"] and out[0]["rows_multiset_ok"]):
        return out
    a, b, w = rand_i32(gen, N, dev), rand_i32(gen, N, dev), rand_i32(gen, N, dev, 1, 3)
    for arm, fn, args in (("torch_sort", single, (a, b, w)),
                          ("split_sort_merge", split, (a, b, w, block))):
        per, _ = slope(fn, args, dev, iters=3)
        out.append(emit(measure=f"{arm}_2^{lgN}", device=name, marginal_s=per,
                        ns_per_elem=per * 1e9 / N))
    # pre-arranged halves, so that the merge is measured alone
    src = cbm.bitonic_input((a, b, w), 2)
    del a, b, w
    per, _ = slope(lambda x: cbm.bitonic_merge(tuple(x), 2, block), (src,), dev, iters=4)
    kernel_ms = None
    if dev.type == "cuda":
        buf = torch.empty_like(src)
        kernel_ms = time_ms(lambda: cbm.bitonic_merge_(buf, 2, block), 5,
                            setup=lambda: buf.copy_(src))
    out.append(emit(measure=f"bitonic_merge_only_2^{lgN}", device=name, marginal_s=per,
                    ns_per_elem=per * 1e9 / N, kernel_ms=kernel_ms))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("lgN", nargs="?", type=int, default=27, help="log2 of the rows (>= 11)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.lgN, args.device)


if __name__ == "__main__":
    main()
