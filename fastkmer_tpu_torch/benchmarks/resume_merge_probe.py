"""Resume/spill merge: the host k-way merge against a round trip through
the card and kernel D.

The port of ``benchmarks/resume_merge_probe.py``, the measurement behind
the JAX package's retirement of its bitonic merge.  The candidate call
site merges sorted parts that live on the HOST and whose result is used
on the host (finalize, writer).  So the device arm pays a pageable H2D of
the padded lanes (as ``jax.device_put`` did), kernel D and the D2H, while
the host arm (``output.native.merge_sorted_parts``, a loser tree) merges
the parts where they lie.  Two parts of unique sorted 2-word keys with
counts, ``n`` rows each before de-duplication (default 2^22).  The device
arm leaves out the run-total epilogue that the host merge performs, so
its time understates the gap.

    python -m fastkmer_tpu_torch.benchmarks.resume_merge_probe [n] [--device cuda|cpu]

prints one JSON line: both arms' best of three, their rows a second, the
host's advantage, and on the card kernel D's own ms by CUDA events.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..output import native as out_native
from ..pipeline import resolve_device
from . import cuda_bitonic_merge as cbm
from ._common import device_name, emit, time_ms

PART_ROWS = 1 << 22
MERGE_BLOCK = 1 << 16  # the JAX probe's block (the TPU tile)


def sorted_part(seed: int, n: int) -> tuple:
    """(words [m, 2] uint32 ascending and unique, counts int64 of 1, bins
    int32 of 0) from n random rows, m <= n."""
    r = np.random.default_rng(seed)
    w = r.integers(0, 1 << 32, size=(n, 2), dtype=np.int64).astype(np.uint32)
    w = w[np.lexsort((w[:, 1], w[:, 0]))]
    keep = np.ones(n, bool)
    keep[1:] = np.any(w[1:] != w[:-1], axis=1)
    w = w[keep]
    return w, np.ones(w.shape[0], np.int64), np.zeros(w.shape[0], np.int32)


def pad_cols(part: tuple, desc: bool, n: int) -> np.ndarray:
    """A sorted part padded to n rows as int32 [3, n] lanes (2 keys, the
    count) with all-ones sentinel keys of count 0, placed so that [A
    ascending | B descending] is bitonic: B reversed, its sentinels leading."""
    w, c, _ = part
    m = w.shape[0]
    cols = np.full((3, n), -1, np.int32)
    cols[2] = 0
    rows = slice(n - m, n) if desc else slice(0, m)
    order = slice(None, None, -1) if desc else slice(None)
    cols[0, rows] = w[order, 0].view(np.int32)
    cols[1, rows] = w[order, 1].view(np.int32)
    cols[2, rows] = c[order]
    return cols


def host_merge(pa: tuple, pb: tuple) -> tuple:
    """The host arm: the native k-way merge of the two parts (equal keys
    summed).  Raises when its library could not be built."""
    merged = out_native.merge_sorted_parts([pa, pb], 2)
    if merged is None:
        raise RuntimeError("the native merge library (output/native/fkmerge.cpp) failed to build")
    return merged


def device_merge(host: np.ndarray, dev: torch.device, block: int) -> np.ndarray:
    """The device arm: the int32 [3, 2n] padded lanes to ``dev`` (a pageable
    copy), merged in place by kernel D, and back to the host."""
    buf = torch.from_numpy(host).to(dev, copy=True)
    cbm.bitonic_merge_(buf, 2, block)
    return buf.cpu().numpy()


def run(n: int = PART_ROWS, device="cuda") -> dict:
    """Both arms on two parts of ``n`` rows (a power of two >= 1024)."""
    dev = resolve_device(device)
    pa, pb = sorted_part(1, n), sorted_part(2, n)
    rows = pa[0].shape[0] + pb[0].shape[0]
    block = min(MERGE_BLOCK, n)

    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        host_merge(pa, pb)
        best = min(best, time.perf_counter() - t)

    host = np.concatenate([pad_cols(pa, False, n), pad_cols(pb, True, n)], axis=1)
    device_merge(host, dev, block)  # the first call builds the kernel
    best_d = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        device_merge(host, dev, block)
        best_d = min(best_d, time.perf_counter() - t)

    kernel_ms = None
    if dev.type == "cuda":
        src = torch.from_numpy(host).to(dev)
        buf = torch.empty_like(src)
        kernel_ms = time_ms(lambda: cbm.bitonic_merge_(buf, 2, block), 5,
                            setup=lambda: buf.copy_(src))
    return emit(
        probe="resume_merge", device=device_name(dev), rows=rows, host_s=best,
        host_mrows_s=rows / best / 1e6, device_roundtrip_s=best_d,
        device_mrows_s=2 * n / best_d / 1e6, host_advantage=best_d / best,
        kernel_ms=kernel_ms,
        note="device arm excludes the run-total epilogue the host merge already "
             "performs: the gap is understated",
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=PART_ROWS, help="rows a part")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.n, args.device)


if __name__ == "__main__":
    main()
