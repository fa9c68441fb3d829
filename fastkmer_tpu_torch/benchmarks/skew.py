"""LPT against hash bin ownership on a repeat-rich corpus.

The port of ``benchmarks/skew.py``: the workload the reference's custom
partitioner exists for (MultiprocessorSchedulingPartitioner.scala:33-69).
``repeat_frac`` of the reads are mutated tandem copies of one 199-base
repeat unit, which concentrates k-mer instances in the few bins of the
repeat's minimizers; the rest are uniform random.  For each owner map
(hash, then LPT from the pre-pass histogram):

* ``imbalance``: the fullest shard's instance load over the mean load;
* ``step_ms``: the median of STEPS streaming steps (a feed and its merge)
  of the whole read set on the ``--mesh``-shard mesh, after a warm-up
  step, each timed alone (``steps_ms``); on a one-card machine every shard
  sits on that card (``placement`` lists them).

    python -m fastkmer_tpu_torch.benchmarks.skew [repeat_frac] [n_reads] [--mesh 8]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..parallel import exchange, partitioner, stream
from ..pipeline import resolve_device
from ._common import device_name, emit, fence

K, M, B, L = 28, 10, 512, 512
STEPS = 5  # timed steps a map: one step of this small corpus is a few ms


def make_skewed_reads(rng, n_reads: int, L: int, repeat_frac: float) -> np.ndarray:
    """``repeat_frac`` of the reads are tandem copies of one 199-base unit
    at a random phase with 1% substitutions; the rest uniform random."""
    unit = rng.integers(0, 4, size=199, dtype=np.uint8)
    reads = rng.integers(0, 4, size=(n_reads, L), dtype=np.int64).astype(np.uint8)
    tandem = np.tile(unit, L // unit.shape[0] + 2)
    for i in range(int(n_reads * repeat_frac)):
        phase = int(rng.integers(0, unit.shape[0]))
        r = tandem[phase : phase + L].copy()
        mut = rng.random(L) < 0.01
        r[mut] = rng.integers(0, 4, size=int(mut.sum()))
        reads[i] = r
    return reads


def run(repeat_frac: float = 0.7, n_reads: int = 256, n: int = 8, device="cuda") -> dict:
    dev = resolve_device(device)
    mesh = exchange.make_mesh(n, dev)
    codes = make_skewed_reads(np.random.default_rng(0), n_reads, L, repeat_frac)
    est = exchange.estimate_bin_sizes(mesh, K, M, B)
    hist = est(exchange.shard_batch(mesh, codes)).cpu().numpy().astype(np.int64)
    positions = (n_reads // n) * (L - K + 1)
    out = {"repeat_frac": repeat_frac, "reads": n_reads, "mesh": n,
           "bins_hot_top8": (np.sort(hist)[-8:][::-1] / max(hist.sum(), 1)).tolist()}
    for name, owner in (("hash", partitioner.hash_owner_map(B, n)),
                        ("lpt", (partitioner.lpt_owner_map(hist, n, B) % n).astype(np.int32))):
        stats = partitioner.balance_stats(hist, owner, n)
        cap = partitioner.size_exchange_cap(hist, owner, n, positions)
        ctr = stream.DistributedCounter(mesh, K, M, B, cap, 1 << 20, owner, fanin=1)
        ctr.feed(codes)
        ctr.check()  # warm-up
        for d in mesh.devices:
            fence(d)
        steps = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            ctr.feed(codes)
            ctr.check()  # reads the counters: waits for the step
            steps.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"imbalance": float(stats["imbalance"]), "cap": int(cap),
                     "step_ms": float(np.median(steps)), "steps_ms": steps}
    out["imbalance_ratio_hash_over_lpt"] = (out["hash"]["imbalance"]
                                            / max(out["lpt"]["imbalance"], 1e-9))
    out["device"] = device_name(dev)
    out["placement"] = [str(d) for d in mesh.devices]
    return emit(**out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("repeat_frac", nargs="?", type=float, default=0.7)
    p.add_argument("n_reads", nargs="?", type=int, default=256)
    p.add_argument("--mesh", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(a.repeat_frac, a.n_reads, a.mesh, a.device)


if __name__ == "__main__":
    main()
