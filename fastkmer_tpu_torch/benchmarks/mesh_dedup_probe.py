"""Mesh transport A/B: raw per-position lanes against the pre-exchange
weighted dedup of the streaming counter, on a duplication-heavy workload.

The port of ``benchmarks/mesh_dedup_probe.py``.  Three arms of
``parallel.stream.DistributedCounter`` over the same host batches (reads
of one random genome) on an n-shard mesh (``exchange.make_mesh``: on a
one-card machine every shard sits on that card):

* ``raw``: ``prededup=False``;
* ``auto``: ``prededup=None``, the adaptive probe (the default);
* ``dedup``: ``prededup=True``.

Each arm runs once as a warm-up and once timed, fenced by ``finalize``;
per arm the wall time, Gbp/s, ``exchange_bytes``, the dedup batches and
the first merge sizes.  The three tables must be equal.  The batches are
fed from the host, as the JAX probe feeds them, so each arm's time holds
its copies to the device.  Defaults: on the card the bench's dup workload
(R = L = 4096, a 2^21-base genome), on the CPU R=512, L=1024, 2^13.

    python -m fastkmer_tpu_torch.benchmarks.mesh_dedup_probe [--n 8] [--reads R] [--len L]
        [--genome G] [--batches 8] [--fanin 8] [--arms raw,auto,dedup] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import bench
from ..parallel import exchange, partitioner, stream
from ..pipeline import resolve_device
from ._common import device_name, emit, log

ARMS = (("raw", False), ("auto", None), ("dedup", True))


def run(n: int = 8, reads: int | None = None, read_len: int | None = None,
        genome: int | None = None, batches: int = 8, fanin: int = 8,
        arms: str = "raw,auto,dedup", device="cuda") -> dict:
    dev = resolve_device(device)
    full = dev.type == "cuda"
    R = reads or (bench.R if full else 512)
    L = read_len or (bench.L if full else 1024)
    G = genome or (bench.DUP_GENOME if full else 1 << 13)
    k, m, b = bench.K, bench.M, bench.B
    mesh = exchange.make_mesh(n, dev)
    host = bench.make_batches(np.random.default_rng(0), R, L, batches, G)
    positions = R * (L - k + 1)
    log(f"n={n} R={R} L={L} G={G} batches={batches}; per-shard distinct share ~ "
        f"{min(1.0, G * 2 / (positions / n)):.3f}")
    owner = partitioner.hash_owner_map(b, n)
    cap = partitioner.size_exchange_cap(np.ones(b), owner, n, (R // n) * (L - k + 1))
    results, tables = {}, {}
    for arm, prededup in (a for a in ARMS if a[0] in arms.split(",")):
        def once():
            ctr = stream.DistributedCounter(mesh, k, m, b, cap, acc_cap=1 << 14, fanin=fanin,
                                            owner_map=owner, prededup=prededup,
                                            unique_ub=G + L)
            for codes in host:
                ctr.feed(codes, n_bases=R * L)
            return ctr, ctr.finalize()  # the one fence

        once()
        t0 = time.perf_counter()
        ctr, out = once()
        dt = time.perf_counter() - t0
        results[arm] = {"arm": arm, "time_s": dt, "gbps": batches * R * L / dt / 1e9,
                        "exchange_bytes": ctr.exchange_bytes,
                        "n_dedup_batches": ctr.n_dedup_batches,
                        "uniques": int(out[0].shape[0]), "merge_rows": ctr.merge_rows[:4]}
        tables[arm] = (out[0].tobytes(), out[1].tobytes())
        log(str(results[arm]))
    if len(set(tables.values())) > 1:
        raise RuntimeError(f"mesh_dedup_probe: the arms' tables differ ({sorted(tables)})")
    summary = {"probe": "mesh_dedup", "n_devices": n, "fanin": fanin, "genome": G,
               "device": device_name(dev), "placement": [str(d) for d in mesh.devices],
               "arms": results}
    if "raw" in results and "dedup" in results:
        summary["bytes_ratio_dedup_vs_raw"] = (results["dedup"]["exchange_bytes"]
                                               / results["raw"]["exchange_bytes"])
    if "raw" in results and "auto" in results:
        summary["speedup_auto_vs_raw"] = results["raw"]["time_s"] / results["auto"]["time_s"]
    return emit(**summary)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--reads", type=int, default=None, help="reads per batch")
    p.add_argument("--len", dest="read_len", type=int, default=None)
    p.add_argument("--genome", type=int, default=None, help="genome bases")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--fanin", type=int, default=8)
    p.add_argument("--arms", default="raw,auto,dedup")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(a.n, a.reads, a.read_len, a.genome, a.batches, a.fanin, a.arms, a.device)


if __name__ == "__main__":
    main()
