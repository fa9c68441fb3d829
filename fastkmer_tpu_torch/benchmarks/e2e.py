"""End-to-end single-device streaming throughput at the bench shapes.

The port of ``benchmarks/e2e.py``: two distinct random [4096, 4096]
batches, staged on the device, cycled ``n_batches`` times through the
deferred accumulator (kernel A per batch into ``add_raw``, one weighted
merge per ``fanin``, a table of 2^``acc_lg`` rows), ended by the last
merge and one fence; one warm-up replays the timed sequence.  Amortized
Gbp/s, every cross-batch merge included.  The workload functions are the
bench's (``fastkmer_tpu_torch.bench``).

    python -m fastkmer_tpu_torch.benchmarks.e2e [n_batches] [fanin] [acc_lg] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import bench, pipeline
from ._common import device_name, emit


def run(n_batches: int = 8, fanin: int = 8, acc_lg: int = 27, R: int = bench.R,
        L: int = bench.L, device="cuda") -> dict:
    dev = pipeline.resolve_device(device)
    rng = np.random.default_rng(0)
    # two distinct batches cycled: a realistic duplication mix
    staged = bench.stage([rng.integers(0, 4, size=(R, L)).astype(np.uint8) for _ in range(2)],
                         dev)
    seq = [staged[i % 2] for i in range(n_batches)]

    def once():
        acc = pipeline.DeviceAccumulator(bench.K, fanin=fanin, m=bench.M, B=bench.B,
                                         acc_cap=1 << acc_lg, device=dev)
        return acc, bench.feed(acc, seq, "raw")

    dt, (acc, stats) = bench.timed(once)
    return emit(metric="e2e_stream_throughput_k28_m10", value=R * L * n_batches / dt / 1e9,
                unit="Gbp/s", seconds=dt, n_batches=n_batches, fanin=fanin,
                acc_cap=acc.acc_cap, n_unique=stats["n_unique"], device=device_name(dev))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_batches", nargs="?", type=int, default=8)
    p.add_argument("fanin", nargs="?", type=int, default=8)
    p.add_argument("acc_lg", nargs="?", type=int, default=27)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.n_batches, args.fanin, args.acc_lg, device=args.device)


if __name__ == "__main__":
    main()
