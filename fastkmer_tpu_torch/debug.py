"""Skew tools — the port of ``fastkmer_tpu.debug``.

* ``find_bin_signatures`` — per bin, each minimizer signature's number of
  super-k-mers; ``save_bin_signatures`` writes one ``bin_signatures<N>.txt``
  per bin with ``<SIGNATURE>\\t<count>`` lines and a ``Total\\t<sum>``
  footer.
* ``evaluate_partition_balance`` — per-partition (bin, size) dump plus
  ``partitioner.balance_stats``.

On CUDA the extraction is the full-mode kernel (``cuda_extract.extract_full``).
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch

from .config import JobConfig
from .core import bits
from .ingest import batch as batching
from .ops import count_sort, cuda_extract, superkmer
from .parallel import partitioner
from .pipeline import resolve_device


def _sig_histogram_batch(codes: torch.Tensor, k: int, m: int, B: int, smax: int):
    """Unique signature -> number of super-k-mer records, by sort-count of
    the signature at each run start (bins carried)."""
    sk, ex = superkmer.group(codes, k, m, B, smax, ex=cuda_extract.extract_full(codes, k, m, B))
    return count_sort.count_sorted(ex.sigs[:, None], sk.bins, sk.is_start)


def _batches(cfg: JobConfig, dev: torch.device):
    for codes, _, _ in batching.batch_file(
        cfg.dataset, cfg.sequence_type, cfg.k, cfg.reads_per_batch, cfg.read_len
    ):
        yield torch.from_numpy(codes).to(dev)


def find_bin_signatures(cfg: JobConfig, smax: int = 64,
                        device="cuda") -> dict[int, dict[str, int]]:
    """bin -> {signature string -> #super-k-mers} over the whole dataset;
    the 4^m sentinel of a window without an allowed m-mer is ``<none>``."""
    dev = resolve_device(device)
    agg: dict[int, dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for codes in _batches(cfg, dev):
        sc = _sig_histogram_batch(codes, cfg.k, cfg.m, cfg.b, smax)
        idx = torch.nonzero(sc.is_uniq).squeeze(1)
        sigs = sc.words[idx, 0].tolist()
        cnts = sc.counts[idx].tolist()
        bins = sc.bins[idx].tolist()
        for s, c, b in zip(sigs, cnts, bins):
            agg[b][s] += c

    sentinel = 1 << (2 * cfg.m)
    return {
        b: {("<none>" if s == sentinel else _sig_str(s, cfg.m)): c for s, c in hist.items()}
        for b, hist in agg.items()
    }


def _sig_str(sig: int, m: int) -> str:
    return bits.decode_codes(
        np.array([(sig >> (2 * (m - 1 - i))) & 3 for i in range(m)], dtype=np.uint8)
    )


def save_bin_signatures(cfg: JobConfig, smax: int = 64, device="cuda") -> str:
    """Write the per-bin signature histograms into cfg.output_dir."""
    hists = find_bin_signatures(cfg, smax, device)
    out_dir = cfg.output_dir
    os.makedirs(out_dir, exist_ok=True)
    for b, hist in hists.items():
        with open(os.path.join(out_dir, f"bin_signatures{b}.txt"), "w") as f:
            tot = 0
            for s, c in sorted(hist.items()):
                f.write(f"{s}\t{c}\n")
                tot += c
            f.write(f"Total\t{tot}\n")
    return out_dir


def evaluate_partition_balance(cfg: JobConfig, owner_map: np.ndarray, out_path: str,
                               device="cuda") -> dict:
    """Dump per-partition loads (``partition <p>\\ttotal <n>`` then
    ``  bin <b>\\t<size>`` lines) to ``out_path``; return balance_stats."""
    dev = resolve_device(device)
    B = cfg.b
    hist = np.zeros(B, dtype=np.int64)
    for codes in _batches(cfg, dev):
        ex = cuda_extract.extract_full(codes, cfg.k, cfg.m, B)
        hist += count_sort.bin_histogram(ex.bins, ex.valid, B).cpu().numpy()

    n_parts = int(owner_map.max()) + 1 if owner_map.size else 1
    per_part: dict[int, list] = defaultdict(list)
    for b in range(B):
        if hist[b]:
            per_part[int(owner_map[b])].append((b, int(hist[b])))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for p in sorted(per_part):
            total = sum(s for _, s in per_part[p])
            f.write(f"partition {p}\ttotal {total}\n")
            for b, s in per_part[p]:
                f.write(f"  bin {b}\t{s}\n")
    return partitioner.balance_stats(hist, owner_map, n_parts)
