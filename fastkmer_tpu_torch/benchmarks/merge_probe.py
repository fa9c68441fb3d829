"""The accumulator merge's parts at the bench scale.

The port of ``benchmarks/merge_probe.py``.  On N = 150,994,944 rows of
random uint32 lanes (the bench merge's input: 8 parts and the table), each
timed after a warm-up (CUDA events on the card):

* the bare 2-key sort of 2 lanes and of 3 lanes (2 keys + 1 value),
  ``count_sort.sort_columns``;
* ``count_sort.count_presentineled`` of 2 keys with weights;
* the whole ``pipeline._acc_merge`` of 8 raw parts of 16,666,624 rows and
  a table of 17,891,328, by default and with ``block_sort=True`` (kernel
  C, the block-sort compaction); the two results must be equal.

``sort_share`` is the 2-lane sort's share of the default merge; the
question it answers: could kernel C's route take the merge's own sort?

    python -m fastkmer_tpu_torch.benchmarks.merge_probe [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import pipeline
from ..ops import count_sort
from ..pipeline import resolve_device
from ._common import device_ms, device_name, emit, log, rand_i32

N_ROWS = 150_994_944  # the bench merge's rows: 8 x 16.67M + 17.9M
PART, TABLE = 16_666_624, 17_891_328
N_PARTS = 8


def run(n_rows: int = N_ROWS, part: int = PART, table: int = TABLE, iters: int = 5,
        device="cuda") -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    cols = [rand_i32(gen, n_rows, dev) for _ in range(3)]
    wts = torch.ones(n_rows, dtype=torch.int32, device=dev)
    out = {"probe": "merge", "rows": n_rows, "device": device_name(dev)}
    out["sort2_ms"] = device_ms(lambda: count_sort.sort_columns(cols[:2]), iters, dev)
    out["sort3_ms"] = device_ms(lambda: count_sort.sort_columns(cols[:2], (cols[2],)), iters,
                                dev)
    out["count_presentineled_ms"] = device_ms(
        lambda: count_sort.count_presentineled(cols[:2], weights=wts), iters, dev)
    log(f"sorts and count: {out}")
    del wts
    # the merge's inputs: 8 raw parts cut from the key lanes, and an empty table
    parts = [((cols[0][i * part:(i + 1) * part], cols[1][i * part:(i + 1) * part]), None)
             for i in range(N_PARTS)]
    acc = pipeline._init_acc_state(table, 2, dev)
    results = {}
    for name, block_sort in (("merge_ms", False), ("merge_block_sort_ms", True)):
        # _acc_merge empties the list it is given: a fresh list each call
        out[name] = device_ms(lambda: pipeline._acc_merge(list(parts), acc, block_sort), iters,
                              dev)
        results[name] = pipeline._acc_merge(list(parts), acc, block_sort)
    (c0, w0, n0, o0), (c1, w1, n1, o1) = results.values()
    if not (all(torch.equal(a, b) for a, b in zip(c0, c1)) and torch.equal(w0, w1)
            and int(n0) == int(n1) and int(o0) == int(o1)):
        raise RuntimeError("merge_probe: the block-sort merge differs from the default merge")
    out["merge_rows"] = N_PARTS * part + table
    out["sort_share"] = out["sort2_ms"] / out["merge_ms"]
    out["block_sort_vs_default"] = out["merge_block_sort_ms"] / out["merge_ms"]
    return emit(**out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    run(device=p.parse_args(argv).device)


if __name__ == "__main__":
    main()
