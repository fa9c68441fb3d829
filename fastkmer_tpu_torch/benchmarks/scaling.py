"""The per-batch mesh step at mesh sizes 1, 2, 4 and 8.

The port of ``benchmarks/scaling.py``.  For each mesh size n,
``reads_per_chip`` · n random reads of ``read_len`` bases (drawn in turn
from one ``default_rng(0)``, as the JAX probe draws them, so that ``cap``,
``exchange_bytes`` and ``dropped`` can be held against it) go through the
whole step (kernel B, route, exchange, count;
``exchange.build_distributed_count``) at k = 28, m = 10, B = 512 with hash
ownership and the exchange capacity sized from the pre-pass histogram
(``partitioner.size_exchange_cap``), as the mesh jobs size it.  One warm
step, then three steps, fenced; each line gives the mean step time, Gbp/s,
the exchange bytes a step at the sized cap and at the worst case (every
window of a shard routed to one owner), ``dropped`` and ``placement``, the
shards' devices.  The summary adds ``scaling_efficiency``: Gbp/s over n
times the one-shard Gbp/s.

``exchange.make_mesh`` places shard i on ``cuda:{i % device_count()}``,
so every mesh size is placed on any number of cards; nothing falls back to
the CPU.  On a machine with one card every shard sits on it and the shards
run one after another, so ``scaling_efficiency`` then measures what the
mesh mechanism costs on one card, not how the step scales over cards.

    python -m fastkmer_tpu_torch.benchmarks.scaling [reads_per_chip] [read_len]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..parallel import exchange, partitioner
from ..pipeline import resolve_device
from ._common import device_name, emit, fence

K, M, B = 28, 10, 512
MESH_SIZES = (1, 2, 4, 8)
STEPS = 3


def prepare(n: int, reads_per_chip: int, L: int, rng, dev: torch.device):
    """One mesh size's step as ``run`` sets it up: ``reads_per_chip`` · n
    reads drawn from ``rng``, the cap sized from the pre-pass histogram.
    -> (step, sharded batch, cap, worst_cap, mesh)."""
    mesh = exchange.make_mesh(n, dev)
    codes = rng.integers(0, 4, size=(reads_per_chip * n, L)).astype(np.uint8)
    owner = partitioner.hash_owner_map(B, n)
    worst_cap = (L - K + 1) * reads_per_chip
    est = exchange.estimate_bin_sizes(mesh, K, M, B)
    hist = est(exchange.shard_batch(mesh, codes)).cpu().numpy().astype(np.int64)
    cap = partitioner.size_exchange_cap(hist, owner, n, worst_cap)
    step = exchange.build_distributed_count(mesh, K, M, B, cap, owner)
    return step, exchange.shard_batch(mesh, codes), cap, worst_cap, mesh


def run(reads_per_chip: int = 64, L: int = 1024, device="cuda") -> list:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    results = []
    for n in MESH_SIZES:
        step, sharded, cap, worst_cap, mesh = prepare(n, reads_per_chip, L, rng, dev)
        R = reads_per_chip * n
        step(sharded)  # warm-up
        for d in set(mesh.devices):
            fence(d)
        t0 = time.perf_counter()
        for _ in range(STEPS):
            sc = step(sharded)
        for d in set(mesh.devices):
            fence(d)
        dt = (time.perf_counter() - t0) / STEPS
        results.append(emit(
            mesh=n, reads=R, step_ms=dt * 1e3, gbps=R * L / dt / 1e9,
            exchange_bytes=exchange.exchange_bytes_per_step(n, cap, K),
            exchange_bytes_worstcase=exchange.exchange_bytes_per_step(n, worst_cap, K),
            dropped=int(sc.dropped), placement=[str(d) for d in mesh.devices],
            device=device_name(dev)))
    base = results[0]["gbps"]
    for r in results[1:]:
        r["scaling_efficiency"] = r["gbps"] / (base * r["mesh"])
    emit(summary=results)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("reads_per_chip", nargs="?", type=int, default=64)
    p.add_argument("read_len", nargs="?", type=int, default=1024)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(a.reads_per_chip, a.read_len, a.device)


if __name__ == "__main__":
    main()
