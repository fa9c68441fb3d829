"""Bitonic merge of two sorted halves: kernel D and its wrapper.

``bitonic_merge`` replaces ``benchmarks/pallas_bitonic_merge.bitonic_merge``
(the Pallas ``_mk_cross_kernel`` and ``_mk_clean_kernel``): int32 [N] lanes
holding uint32 bit patterns, keys first, whose rows are [A ascending | B
descending] (N/2 rows each, ordered lexicographically over the first
``num_keys`` lanes as unsigned values), come out as one ascending sequence;
the other lanes ride along.  Ties land in no particular order and the rows
stay the same multiset, as with the Pallas version.  N is a power of two
>= 2 block and ``block`` a power of two >= 1024, the bounds the JAX version
asserts, so the same calls are legal in both packages.  ``block`` is the
TPU's tile and nothing more here: the kernel picks its own shared-memory
tile from the lane count, ``tile_rows(lanes, N)``, the largest power of two
<= N whose lanes fit in 227 KB.  Strides from N/2 down to the tile take one
device-memory pass each, the rest one pass.

For the halves to be bitonic, A's sentinels (all-ones keys) end A and B's
lead B: sort B on bit-NOT keys and NOT them back, as ``bitonic_input`` does.

The kernel lives in ``csrc/bitonic_merge.cu``; its header says what bounds
it and how it is staged.  For a CUDA tensor the wrapper launches it or
raises; only a CPU tensor takes the plain version,
``bitonic_merge_reference``.  ``LAUNCHES`` counts the kernel's launches
(one a call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.tbits import pair_key
from ..ops import count_sort
from ..ops.cuda_sort import tile_rows  # rows a CTA merges in shared memory (227 KB)
from ..utils import cudabuild

LAUNCHES = 0

MIN_BLOCK = 1024


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cudabuild.load("fkbitonicmerge", ("bitonic_merge.cu",))
    lib.fk_bitonic_merge.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fk_bitonic_merge.restype = ctypes.c_int
    return lib


def _check(cols: tuple, num_keys: int, block: int) -> None:
    if not 1 <= num_keys <= len(cols):
        raise ValueError(f"num_keys={num_keys} outside [1, {len(cols)}]")
    if block < MIN_BLOCK or block & (block - 1):
        raise ValueError(f"block={block} is not a power of two >= {MIN_BLOCK}")
    N = cols[0].shape[0]
    if N & (N - 1) or N < 2 * block:
        raise ValueError(f"N={N} is not a power of two >= 2 * block = {2 * block}")
    for c in cols:
        if c.dtype != torch.int32 or c.shape != (N,) or c.device != cols[0].device:
            raise TypeError("lanes must be int32 [N] tensors on one device")


def _less(x: list, y: list) -> torch.Tensor:
    """Row-wise x < y, lexicographic over the key lanes as unsigned values,
    two lanes at a time as order-preserving int64 keys (``pair_key``)."""
    lt = eq = None
    for w in range(0, len(x), 2):
        kx = pair_key(x[w], x[w + 1] if w + 1 < len(x) else None)
        ky = pair_key(y[w], y[w + 1] if w + 1 < len(y) else None)
        if lt is None:
            lt, eq = kx < ky, kx == ky
        else:
            lt = lt | (eq & (kx < ky))
            eq = eq & (kx == ky)
    return lt


def _network_(lanes: tuple, num_keys: int) -> None:
    """The merge network in place on [N] lanes: for s = N/2 .. 1, rows i and
    i + s of each 2s-row group (a ``view(G, 2, s)``) swap every lane where
    the upper row is strictly less."""
    N = lanes[0].shape[0]
    s = N // 2
    while s >= 1:
        lo = [c.view(-1, 2, s)[:, 0] for c in lanes]
        hi = [c.view(-1, 2, s)[:, 1] for c in lanes]
        swap = _less(hi[:num_keys], lo[:num_keys])
        for a, b in zip(lo, hi):
            a_new = torch.where(swap, b, a)
            b.copy_(torch.where(swap, a, b))
            a.copy_(a_new)
        s //= 2


def bitonic_merge_reference(cols: tuple, num_keys: int, block: int = 1 << 16) -> tuple:
    """Plain torch version: the same network, log2 N stages of
    compare-exchange, on copies of the lanes."""
    _check(tuple(cols), num_keys, block)
    lanes = tuple(c.clone() for c in cols)
    _network_(lanes, num_keys)
    return lanes


def bitonic_merge(cols: tuple, num_keys: int, block: int = 1 << 16) -> tuple:
    """Merge [A ascending | B descending] int32 [N] lanes into one ascending
    sequence.  Returns new lanes (views of one [lanes, N] buffer), as the
    JAX version returns new arrays; the inputs are not modified."""
    _check(tuple(cols), num_keys, block)
    return bitonic_merge_(torch.stack(tuple(cols)), num_keys, block)


def bitonic_merge_(buf: torch.Tensor, num_keys: int, block: int = 1 << 16) -> tuple:
    """``bitonic_merge`` in place on a contiguous int32 [lanes, N] buffer,
    for a caller that builds its lanes there (the JAX version has no
    in-place form: it returns new arrays).  Returns the buffer's lanes."""
    global LAUNCHES
    if buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError("the buffer must be a contiguous [lanes, N] tensor")
    cols = buf.unbind(0)
    _check(cols, num_keys, block)
    dev = buf.device
    if dev.type == "cpu":
        _network_(cols, num_keys)
        return cols
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = buf.shape[1]
    err = library().fk_bitonic_merge(
        buf.data_ptr(), N, len(cols), num_keys, tile_rows(len(cols), N), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bitonic merge kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return cols


def bitonic_input(cols: tuple, num_keys: int) -> torch.Tensor:
    """A [lanes, N] buffer of the rows of ``cols`` arranged for the merge:
    the first N/2 rows sorted ascending, the last N/2 descending (sorted on
    bit-NOT keys, NOT back), so B's sentinels lead B.  Sorts by
    ``count_sort.sort_columns`` (torch.sort of packed keys)."""
    N = cols[0].shape[0]
    buf = torch.empty((len(cols), N), dtype=torch.int32, device=cols[0].device)
    for part, desc in ((slice(0, N // 2), False), (slice(N // 2, N), True)):
        keys = [~c[part] if desc else c[part] for c in cols[:num_keys]]
        skeys, svals = count_sort.sort_columns(keys, tuple(c[part] for c in cols[num_keys:]))
        for i, c in enumerate(list(skeys) + list(svals)):
            buf[i, part] = ~c if desc and i < num_keys else c
    return buf
