"""Kernel C, the block sort, by block size, against one library sort.

The port of ``benchmarks/pallas_sort_probe.py`` (the file keeps its name
so that a reader finds the counterpart; it drives kernel C,
``cuda_sort.sort_blocks``, ``csrc/block_sort.cu``).  On N = 2^lgN rows of
three int32 lanes (2 keys + 1 value, uniform uint32 bit patterns drawn from
``default_rng(0)`` as the JAX probe draws them):

* ``hw_exactness``: on the first ``NV`` rows in blocks of ``VB``, the
  kernel's key lanes must equal its plain version's
  (``cuda_sort.sort_blocks_reference``) and each block must keep its
  multiset of rows; a mismatch raises;
* ``block_sort_{block}`` for each block size: ``marginal_ms`` and
  ``naive_ms`` of ``sort_blocks`` (a new buffer each call), by the slope
  of the host clock (``_common.slope``); ``ns_per_elem``,
  ``ns_per_elem_stage`` over the network's ``stages`` (those of
  ``cuda_sort.stage_plan``, the JAX probe's ``n_stages``); ``kernel_ms``, the
  in-place kernel alone (``sort_blocks_`` on a buffer refilled outside the
  timed span, CUDA events, median); the bound (each lane read and written
  once at ``HBM_BYTES_PER_S``) and ``cuda_sort.stage_plan``'s route,
  cluster size and rows a CTA;
* ``torch_sort_2key_1val``: the library's answer to the same function at
  the same N, as one global ``torch.sort`` of the packed int64 key of the
  two key lanes (``tbits.pair_key``; the sorted key holds both key lanes)
  and a gather of the value lane, which is what the JAX probe's
  ``lax.sort((a, b, c), num_keys=2)`` computes.

    python -m fastkmer_tpu_torch.benchmarks.pallas_sort_probe [lgN] [blocks...]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.tbits import pair_key
from ..ops import cuda_sort
from ..pipeline import resolve_device
from ._common import HBM_BYTES_PER_S, device_ms, device_name, emit, slope

LG_N = 24
BLOCKS = (1 << 15, 1 << 16, 1 << 17)
NV, VB = 1 << 18, 1 << 15  # the exactness check's rows and block
ITERS = 4


def _rows_by_block(cols: list, block: int) -> np.ndarray:
    """[N / block, block, lanes] uint32 rows, each block's rows sorted."""
    rows = np.stack([c.cpu().numpy().view(np.uint32) for c in cols], 1)
    rows = rows.reshape(-1, block, len(cols))
    return np.stack([b[np.lexsort(b.T[::-1])] for b in rows])


def hw_exactness(cols: list, dev: torch.device) -> dict:
    """The kernel against its plain version on the first NV rows; raises on
    a mismatch."""
    nv = min(NV, cols[0].shape[0])
    vb = min(VB, nv)
    vcols = tuple(c[:nv] for c in cols)
    got = cuda_sort.sort_blocks(vcols, 2, vb)
    ref = cuda_sort.sort_blocks_reference(vcols, 2, vb)
    keys_ok = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    vals_ok = bool(np.array_equal(_rows_by_block(got, vb), _rows_by_block(ref, vb)))
    if not (keys_ok and vals_ok):
        raise RuntimeError(f"pallas_sort_probe: the block sort is not exact on {nv} rows in "
                           f"blocks of {vb}: keys {keys_ok}, rows {vals_ok}")
    return emit(measure="hw_exactness", keys_ok=keys_ok, vals_multiset_ok=vals_ok, rows=nv,
                block=vb, device=device_name(dev))


def run(lgN: int = LG_N, blocks=BLOCKS, device="cuda") -> list:
    dev = resolve_device(device)
    N = 1 << lgN
    rng = np.random.default_rng(0)
    cols = [torch.from_numpy(rng.integers(0, 2**32, size=N, dtype=np.uint32).view(np.int32)
                             ).to(dev) for _ in range(3)]
    lines = [hw_exactness(cols, dev)]
    bound_ms = N * len(cols) * 4 * 2 / HBM_BYTES_PER_S * 1e3
    src = torch.stack(cols)
    buf = torch.empty_like(src)
    for block in blocks:
        per, naive = slope(lambda: cuda_sort.sort_blocks(cols, 2, block), (), dev, iters=ITERS)
        kernel_ms = device_ms(lambda: cuda_sort.sort_blocks_(buf, 2, block), ITERS, dev,
                              setup=lambda: buf.copy_(src))
        plan = cuda_sort.stage_plan(len(cols), block)
        st = len(plan.stages)
        lines.append(emit(
            measure=f"block_sort_{block}", marginal_ms=per * 1e3, ns_per_elem=per * 1e9 / N,
            ns_per_elem_stage=per * 1e9 / N / st, stages=st, naive_ms=naive * 1e3,
            kernel_ms=kernel_ms, bound_ms=bound_ms, bound_share=bound_ms / kernel_ms,
            route=plan.route, cluster=plan.cluster, rows_per_cta=plan.rows_per_cta, rows=N,
            device=device_name(dev)))
    del buf, src

    def library_sort():
        key, idx = torch.sort(pair_key(cols[0], cols[1]))
        return key, cols[2][idx]

    per, naive = slope(library_sort, (), dev, iters=ITERS)
    lines.append(emit(measure="torch_sort_2key_1val", marginal_ms=per * 1e3,
                      ns_per_elem=per * 1e9 / N, naive_ms=naive * 1e3,
                      ms=device_ms(library_sort, ITERS, dev), rows=N, device=device_name(dev)))
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("lgN", nargs="?", type=int, default=LG_N)
    p.add_argument("blocks", nargs="*", type=int)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(a.lgN, a.blocks or BLOCKS, device=a.device)


if __name__ == "__main__":
    main()
