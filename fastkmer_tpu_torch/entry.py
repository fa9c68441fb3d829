"""Entry points of the port — the counterparts of the repository's
``__graft_entry__.py``:

* ``entry()``: the single-device step (the full-mode extract, then
  ``count_sort.count_sorted``) and its input;
* ``dryrun_multichip(n)``: an n-shard mesh (``exchange.make_mesh``: on
  CUDA shard i on card i % device_count(), so all on one card of a
  one-card machine) through the histogram pre-pass, the LPT owner map, one
  distributed count step, the streaming counter, the dedup transport and
  the sequence lane, on tiny shapes, with the JAX dry run's checks.

Both run on the card unless the caller passes ``device="cpu"``, where the
extract is kernel B's plain version; CUDA asked for and absent raises.

    python -m fastkmer_tpu_torch.entry [--dryrun N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .ops import count_sort, cuda_extract
from .pipeline import resolve_device

K, M, B = 28, 10, 512


def entry(device="cuda"):
    """-> (step, (codes,)): ``codes`` [64, 1024] uint8 from
    ``default_rng(0)`` on the device; ``step(codes)`` -> (words, counts,
    bins, is_uniq, n_valid) of the batch's sorted unique-run view at
    k=28, m=10, B=512 (kernel B on a CUDA tensor)."""
    dev = resolve_device(device)

    def step(codes: torch.Tensor):
        ex = cuda_extract.extract_full(codes, K, M, B)
        sc = count_sort.count_sorted(ex.words, ex.bins, ex.valid)
        return sc.words, sc.counts, sc.bins, sc.is_uniq, sc.n_valid

    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, size=(64, 1024)).astype(np.uint8)).to(dev)
    return step, (codes,)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run one of each mesh program on an ``n_devices``-shard mesh at tiny
    shapes (k=28, m=10, B=64, cap=128; [4n, 96] codes from
    ``default_rng(1)`` with 2% N) and check them against each other.
    Prints the JAX dry run's line; -> its five numbers: ``n_counted``
    (the one-shot step's instances), ``stream_total`` and
    ``stream_unique`` (the streaming counter fed twice), ``dedup_total``
    (the dedup transport fed twice), ``seq_pairs`` ((k-mer, seq) pairs of
    the sequence lane)."""
    from .parallel import exchange, partitioner, stream

    mesh = exchange.make_mesh(n_devices, device)
    k, m, b, cap = 28, 10, 64, 128
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=(4 * n_devices, 96)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4  # some Ns
    sharded = exchange.shard_batch(mesh, codes)

    # histogram pre-pass -> LPT owner map -> one distributed step
    hist = exchange.estimate_bin_sizes(mesh, k, m, b)(sharded).cpu().numpy()
    owner = partitioner.lpt_owner_map(hist, n_devices, b)
    sc = exchange.build_distributed_count(mesh, k, m, b, cap, owner)(sharded)
    _check(int(sc.dropped) == 0, f"{int(sc.dropped)} rows dropped")
    n_counted = sum(int(v) for v in sc.n_valid)
    _check(n_counted > 0, "counted no k-mers")

    def counter(**kw):
        return stream.DistributedCounter(mesh, k, m, b, cap, acc_cap=1 << 12, owner_map=owner,
                                         fanin=2, **kw)

    # the streaming path: exchange -> fan-in merge -> finalize
    ctr = counter()
    ctr.feed(codes)
    ctr.feed(codes)
    words, counts, _ = ctr.finalize()
    _check(int(counts.sum()) == 2 * n_counted, "the streaming path disagrees")
    # the dedup transport: (words, weight) of each shard's distinct rows
    dctr = counter(prededup=True)
    dctr.feed(codes)
    dctr.feed(codes)
    _, dcounts, _ = dctr.finalize()
    _check(int(dcounts.sum()) == 2 * n_counted, "the dedup transport disagrees")
    _check(dctr.n_dedup_batches == 2, f"{dctr.n_dedup_batches} dedup batches, not 2")
    # the sequence lane (multiseq's): the id rides as one more key lane
    mctr = counter(with_seq=True)
    mctr.feed(codes, seq_ids=np.arange(codes.shape[0], dtype=np.int32) % 3)
    mwords, mcounts, _ = mctr.finalize()
    _check(int(mcounts.sum()) == n_counted, "the sequence lane disagrees")
    out = {"n_counted": n_counted, "stream_total": int(counts.sum()),
           "stream_unique": int(words.shape[0]), "dedup_total": int(dcounts.sum()),
           "seq_pairs": int(mwords.shape[0])}
    print(
        f"dryrun_multichip({n_devices}): ok, counted {n_counted} k-mer "
        f"instances (one-shot) + {out['stream_total']} (streaming, "
        f"{out['stream_unique']} uniques) + dedup transport "
        f"({out['dedup_total']} instances) + multiseq lanes "
        f"({out['seq_pairs']} (kmer,seq) pairs)"
    )
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dryrun", type=int, default=None, metavar="N",
                   help="run dryrun_multichip(N) instead of the entry step")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, args.device)
        return
    step, (codes,) = entry(args.device)
    words, counts, _bins, is_uniq, n_valid = step(codes)
    print(json.dumps({"n_valid": int(n_valid), "n_unique": int(is_uniq.sum()),
                      "max_count": int(counts.max()), "rows": int(words.shape[0])}))


if __name__ == "__main__":
    main()
