"""The device Gram against the host Gram for the pairwise distances.

The port of ``benchmarks/distance_probe.py``: ``accumulate_distances`` on
the host (float64 blocked BLAS over dense [groups, S] count blocks)
against ``device=True`` (the masked block matmul of
``multiseq.pipeline._pair_sums`` on the card, table columns shipped from
the host included) at S in {8, 64, 256}, over synthetic sorted
(k-mer, seq, count) tables with counts in [1, 1000).

    python -m fastkmer_tpu_torch.benchmarks.distance_probe [--measure NAME] [--scale 1.0]
        [--device cuda|cpu]

prints one JSON line per S: the host's and the device path's seconds (host
clock; the device path ends in its copy back), the device Gram alone on
tensors already on the device (CUDA events on the card), and the largest
difference relative to the largest distance, which must be below 1e-4.
``--scale`` shrinks the tables (e.g. 0.01 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..multiseq import distances as dm
from ..multiseq import pipeline as mp
from ..pipeline import resolve_device
from ._common import device_name, emit, log, slope, time_ms

SHAPES = ((8, 1 << 20, 0.6), (64, 1 << 18, 0.3), (256, 1 << 16, 0.2))  # S, k-mers, presence


def make_table(rng, n_kmers: int, S: int, present_p: float):
    """Sorted unique-(group, seq) rows with ~present_p presence."""
    keep = rng.random((n_kmers, S)) < present_p
    g, s = np.nonzero(keep)
    counts = rng.integers(1, 1000, size=g.shape[0]).astype(np.int64)
    return g.astype(np.int64), s.astype(np.int32), counts


def run(measure_name: str = "multisequence.SquaredEuclidean", scale: float = 1.0,
        device="cuda", seed: int = 0) -> list:
    dev = resolve_device(device)
    measure = dm.get_measure(measure_name)
    rng = np.random.default_rng(seed)
    rows = []
    for S, n_kmers, present_p in SHAPES:
        gid, seqs, counts = make_table(rng, max(1, int(n_kmers * scale)), S, present_p)
        U = gid.shape[0]
        words = np.stack([(gid & 0xFFFFFFFF).astype(np.uint32),
                          ((gid * 7 + 1) & 0xFFFFFFFF).astype(np.uint32)], 1)
        t0 = time.perf_counter()
        host = mp.accumulate_distances(words, seqs, counts, S, measure)
        t_host = time.perf_counter() - t0
        mp.accumulate_distances(words, seqs, counts, S, measure, device=dev)  # warm-up
        t0 = time.perf_counter()
        got = mp.accumulate_distances(words, seqs, counts, S, measure, device=dev)
        t_dev = time.perf_counter() - t0
        # the Gram alone, its three columns already on the device
        T = 2048
        Np = -(-U // T) * T
        g = torch.full((Np,), -1, dtype=torch.int32, device=dev)
        g[:U] = torch.from_numpy(gid.astype(np.int32))
        sq = torch.zeros(Np, dtype=torch.int32, device=dev)
        sq[:U] = torch.from_numpy(seqs)
        c = torch.zeros(Np, dtype=torch.float32, device=dev)
        c[:U] = torch.from_numpy(counts.astype(np.float32))

        def gram():
            return mp._pair_sums(g, sq, c, S, measure, T)

        gram_ms = (time_ms(gram, 5) if dev.type == "cuda"
                   else slope(gram, (), dev, iters=1, warmup=1)[0] * 1e3)
        del g, sq, c
        err = float(np.abs(got - host).max() / max(np.abs(host).max(), 1.0))
        log(f"S={S}: host {t_host:.4f} s, device path {t_dev:.4f} s, Gram {gram_ms:.4f} ms, "
            f"max rel err {err:.3e}")
        if err >= 1e-4:
            raise RuntimeError(f"S={S}: device Gram off by {err:.3e} relative")
        rows.append(emit(probe="distance_probe", device=device_name(dev), measure=measure.name,
                         S=S, U=U, work_US=U * S, host_s=t_host, device_s=t_dev,
                         device_gram_ms=gram_ms, speedup=t_host / t_dev, max_rel_err=err))
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--measure", default="multisequence.SquaredEuclidean")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(a.measure, a.scale, a.device)


if __name__ == "__main__":
    main()
