"""The HT engine (useHT=1) against the sort engine, per count step.

The port of ``benchmarks/ht_vs_sort.py``.  Both steps take the same
pre-extracted words (the extract is the same for both engines) with ~3%
invalid rows: the sort engine's ``count_sorted`` sorts the W key words
(plus a flag at k % 16 == 0); the HT engine's ``count_hashed`` sorts a
64-bit fingerprint and the flag, and permutes the W words after it.

    python -m fastkmer_tpu_torch.benchmarks.ht_vs_sort [--rows N] [--k 28 55 97] [--device cuda|cpu]

prints one JSON line per k: both steps' times (CUDA events on the card, the
host clock's marginal slope on the CPU) and their ratio.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.bits import num_words
from ..ops import count_hash, count_sort
from ..pipeline import resolve_device
from ._common import device_name, emit, fence, slope, time_ms

ROWS = 4096 * (4096 - 28 + 1)  # one batch of chip_smoke.py's phase 5 at k=28
KS = (28, 55, 97)


def packed_words(rng, k: int, n: int) -> np.ndarray:
    """[n, W] random packed k-mer words (pad bits zero), as int32."""
    W = num_words(k)
    words = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    if k % 16:
        words[:, W - 1] &= np.uint32((0xFFFFFFFF << (32 - 2 * (k % 16))) & 0xFFFFFFFF)
    return words.view(np.int32)


def run(k: int, rows: int = ROWS, device="cuda", seed: int = 0) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(packed_words(rng, k, rows)).to(dev)
    valid = torch.from_numpy(rng.random(rows) < 0.97).to(dev)
    safe = count_sort.sentinel_safe_for(k)

    def sort_step():
        return count_sort.count_sorted(words, None, valid, sentinel_safe=safe)

    def ht_step():
        return count_hash.count_hashed(words, None, valid)

    a, (b, coll) = sort_step(), ht_step()  # the same table, and no collision
    ua = a.words[a.is_uniq]
    ub, _ = count_hash.unique_in_kmer_order(b)
    same = bool(torch.equal(ua, ub)) and not bool(coll)
    del a, b, ua, ub
    if dev.type == "cuda":
        sort_ms, ht_ms = time_ms(sort_step, 5), time_ms(ht_step, 5)
    else:
        sort_ms = slope(sort_step, (), dev, iters=2, warmup=1)[0] * 1e3
        ht_ms = slope(ht_step, (), dev, iters=2, warmup=1)[0] * 1e3
    fence(dev)
    return emit(probe="ht_vs_sort", device=device_name(dev), k=k, W=num_words(k), rows=rows,
                sort_ms=sort_ms, ht_ms=ht_ms, ht_over_sort=ht_ms / sort_ms, same_table=same)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--k", type=int, nargs="+", default=list(KS))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    for k in args.k:
        run(k, args.rows, args.device)


if __name__ == "__main__":
    main()
