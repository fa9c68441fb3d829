"""The super-k-mer mesh step with kernel B against the plain extractor.

The port of ``benchmarks/smer_pallas_probe.py`` (the file keeps its name so
that a reader finds the counterpart; the arms are named ``kernel`` and
``plain``).  The per-batch super-k-mer step
(``exchange.build_distributed_count_smer``: extract, ``superkmer.group``,
route, exchange, expand, count) on a one-shard mesh, with hash ownership,
K = 28 by default, M = 10, B = 512, SMAX = 64 and ``cap`` = a third of the
batch's window starts, on R reads of L bases cut from a
(2^22 + L)-base random genome (drawn as the JAX probe draws them):

* ``plain``: the step with ``extract.extract`` as its stage-1 extractor;
* ``kernel``: the public step, which extracts with kernel B
  (``cuda_extract.extract_full``).

Each arm's line gives its ms a batch (CUDA events on the card, the median
of ``iters`` steps after a warm-up), Gbp/s, ``dropped`` (it must be 0) and
``kernel_launches``, the launches of kernel B made while that arm ran (0
for ``plain``); both arms' compacted tables must be equal.  The last line
is the kernel's speed-up over the plain step.

    python -m fastkmer_tpu_torch.benchmarks.smer_pallas_probe [k] [iters] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np

from ..ops import cuda_extract, extract
from ..parallel import exchange, partitioner
from ..pipeline import resolve_device
from ._common import device_ms, device_name, emit

K, ITERS = 28, 4
M, B = 10, 512
R, L = 512, 4096
SMAX = 64
# the step builders of the two arms: the plain one passes the plain extractor
# to the step the public builder makes
ARMS = {
    "plain": functools.partial(exchange._build_count_smer, use_ht=False,
                               extract_fn=extract.extract),
    "kernel": exchange.build_distributed_count_smer,
}


def make_reads(rng, R: int, L: int) -> np.ndarray:
    """R reads of L bases at random starts of a (2^22 + L)-base genome."""
    genome = rng.integers(0, 4, size=(1 << 22) + L, dtype=np.int64).astype(np.uint8)
    starts = rng.integers(0, 1 << 22, size=R)
    return genome[starts[:, None] + np.arange(L)[None, :]]


def run(k: int = K, iters: int = ITERS, R: int = R, L: int = L, device="cuda") -> list:
    dev = resolve_device(device)
    mesh = exchange.make_mesh(1, dev)
    owner = partitioner.hash_owner_map(B, 1)
    codes = make_reads(np.random.default_rng(0), R, L)
    # records <= positions / mean run; a third is ample for a random genome
    # (a mean super-k-mer run of about 4-5 at k = 28, m = 10) and the same for
    # both arms
    cap = R * (L - k + 1) // 3
    lines, tables = [], {}
    for arm, build in ARMS.items():
        before = cuda_extract.FULL_LAUNCHES
        step = build(mesh, k, M, B, cap, SMAX, owner)
        sharded = exchange.shard_batch(mesh, codes)
        sc = step(sharded)
        dropped = int(sc.dropped)
        if dropped:
            raise RuntimeError(f"smer_pallas_probe: the {arm} arm dropped {dropped} records: "
                               f"cap {cap} is too small")
        tables[arm] = exchange.compact_shard_counts(sc)
        del sc
        ms = device_ms(lambda: step(sharded), iters, dev)
        lines.append(emit(probe="smer", arm=arm, k=k, ms=ms, gbps=R * L / ms / 1e6,
                          dropped=dropped, cap=cap, n_unique=int(tables[arm][0][0].shape[0]),
                          kernel_launches=cuda_extract.FULL_LAUNCHES - before,
                          device=device_name(dev)))
    (pw, pc, pb), (kw, kc, kb) = tables["plain"][0], tables["kernel"][0]
    if not (np.array_equal(pw, kw) and np.array_equal(pc, kc) and np.array_equal(pb, kb)):
        raise RuntimeError("smer_pallas_probe: the kernel arm's table differs from the plain "
                           "arm's")
    lines.append(emit(probe="smer", k=k, speedup_kernel_over_plain=lines[0]["ms"]
                      / lines[1]["ms"], device=device_name(dev)))
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("k", nargs="?", type=int, default=K)
    p.add_argument("iters", nargs="?", type=int, default=ITERS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(a.k, a.iters, device=a.device)


if __name__ == "__main__":
    main()
