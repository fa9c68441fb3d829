"""Merge of two sorted halves: kernel D and its wrapper.

``bitonic_merge`` replaces ``benchmarks/pallas_bitonic_merge.bitonic_merge``
(the Pallas ``_mk_cross_kernel`` and ``_mk_clean_kernel``): int32 [N] lanes
holding uint32 bit patterns, keys first, whose rows are [A ascending | B
descending] (N/2 rows each, ordered lexicographically over the first
``num_keys`` lanes as unsigned values), come out as one ascending sequence;
the other lanes ride along.  Ties land in no particular order and the rows
stay the same multiset, as with the Pallas version.  N is a power of two
>= 2 block and ``block`` a power of two >= 1024, the bounds the JAX version
asserts, so the same calls are legal in both packages.  ``block`` is the
TPU's tile and nothing more here.

The kernel is a merge path (``csrc/bitonic_merge.cu``; its header says what
bounds it): a partition launch finds, for each output tile of
``merge_tile(lanes, N)`` rows, how many of its rows come from A, and a merge
launch builds each tile in shared memory from A and B read backwards.  It
needs exactly the shape above, both halves sorted with A's sentinels
(all-ones keys) at A's end and B's at B's front (``bitonic_input`` sorts B
on bit-NOT keys and NOTs them back), not any bitonic sequence.  The merge is
out of place: ``bitonic_merge`` returns the new buffer's lanes,
``merge_into`` writes a caller's buffer (with the caller's scratch for the
partition), and ``bitonic_merge_`` keeps its in-place contract by a copy
back on the card.  ``merge_path_twin`` is the kernel's partition,
per-thread co-ranks and tie rule in torch, at a small tile, for the CPU
tests.

For a CUDA tensor the wrappers launch the kernel or raise; only a CPU tensor
takes the plain version, ``bitonic_merge_reference`` (the network the TPU
ran).  ``LAUNCHES`` counts the kernel's runs (partition and merge, one a
call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.tbits import pair_key
from ..ops import count_sort
from ..utils import cudabuild

LAUNCHES = 0

MIN_BLOCK = 1024
MERGE_THREADS = 256  # threads of a merge CTA
TILE_BYTES = 32768  # shared memory of a merge CTA where it can: six fit an SM
SMEM_BYTES = 232448  # the 227 KB a CTA may opt into


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cudabuild.load("fkbitonicmerge", ("bitonic_merge.cu",))
    lib.fk_merge_path.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fk_merge_path.restype = ctypes.c_int
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


def merge_tile(lanes: int, N: int) -> int:
    """Output rows a merge CTA builds: the largest power of two <= N whose
    rows and source indices ((lanes + 1) · 4 bytes a row) fit in
    ``TILE_BYTES``, or in the whole 227 KB when that leaves fewer rows than
    threads."""
    for budget in (TILE_BYTES, SMEM_BYTES):
        tile = 1 << ((budget // (4 * (lanes + 1))).bit_length() - 1)
        if tile >= MERGE_THREADS:
            return min(tile, N)
    raise ValueError(f"{lanes} lanes: a merge tile of {MERGE_THREADS} rows does not fit")


def bitonic_merge(cols: tuple, num_keys: int, block: int = 1 << 16) -> tuple:
    """Merge [A ascending | B descending] int32 [N] lanes into one ascending
    sequence.  Returns new lanes (views of one [lanes, N] buffer), as the
    JAX version returns new arrays; the inputs are not modified."""
    _check(tuple(cols), num_keys, block)
    src = torch.stack(tuple(cols))
    if src.device.type == "cpu":
        return bitonic_merge_(src, num_keys, block)
    out = torch.empty_like(src)
    return merge_into(src, out, _splits(src), num_keys)


def _splits(buf: torch.Tensor) -> torch.Tensor:
    """The partition's scratch: one int64 a tile boundary."""
    lanes, N = buf.shape
    return torch.empty(N // merge_tile(lanes, N) + 1, dtype=torch.int64, device=buf.device)


def _buffer(buf: torch.Tensor, num_keys: int, block: int) -> tuple:
    if buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError("the buffer must be a contiguous [lanes, N] tensor")
    cols = buf.unbind(0)
    _check(cols, num_keys, block)
    return cols


def merge_into(src: torch.Tensor, out: torch.Tensor, splits: torch.Tensor,
               num_keys: int) -> tuple:
    """The kernel's two launches: merge the contiguous int32 [lanes, N] ``src``
    into ``out`` (same shape, not overlapping it), with ``splits`` (int64,
    N / merge_tile(lanes, N) + 1) as the partition's scratch.  CUDA tensors
    only.  Returns ``out``'s lanes."""
    global LAUNCHES
    _buffer(src, num_keys, MIN_BLOCK)
    cols = _buffer(out, num_keys, MIN_BLOCK)
    lanes, N = src.shape
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"merge_into runs the kernel: {dev} is not a CUDA device")
    if out.shape != src.shape or out.device != dev or splits.device != dev:
        raise ValueError("src and out must have one shape and one device with splits")
    tile = merge_tile(lanes, N)
    if splits.dtype != torch.int64 or splits.numel() < N // tile + 1:
        raise ValueError(f"splits must hold {N // tile + 1} int64")
    lo, hi = src.data_ptr(), src.data_ptr() + src.numel() * 4
    if lo < out.data_ptr() + out.numel() * 4 and out.data_ptr() < hi:
        raise ValueError("the merge is out of place: out overlaps src")
    err = library().fk_merge_path(
        src.data_ptr(), out.data_ptr(), splits.data_ptr(), N, lanes, num_keys, tile,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"merge path kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return cols


def bitonic_merge_(buf: torch.Tensor, num_keys: int, block: int = 1 << 16) -> tuple:
    """``bitonic_merge`` in place on a contiguous int32 [lanes, N] buffer,
    for a caller that builds its lanes there (the JAX version has no
    in-place form: it returns new arrays).  On the card the kernel writes a
    new buffer, copied back.  Returns the buffer's lanes."""
    cols = _buffer(buf, num_keys, block)
    dev = buf.device
    if dev.type == "cpu":
        _network_(cols, num_keys)
        return cols
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(buf)
    merge_into(buf, out, _splits(buf), num_keys)
    buf.copy_(out)
    return cols


def _key_at(lanes: list, idx: torch.Tensor) -> list:
    return [c[idx] for c in lanes]


def _corank(d, na, nb, a_key, b_key) -> torch.Tensor:
    """For each diagonal d (with its ranges' lengths na, nb): the co-rank i,
    A's rows among the first d of the merge, by the kernel's binary search
    and tie rule (move right past A[mid] unless B[d - 1 - mid] is strictly
    less).  ``a_key(idx)`` / ``b_key(idx)`` give the key lanes at indices
    clamped into range; every argument is an int64 tensor of one shape."""
    lo = (d - nb).clamp(min=0)
    hi = torch.minimum(d, na)
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) // 2
        b_less = _less(b_key((d - 1 - mid).clamp(min=0)), a_key(mid))
        lo = torch.where(live & ~b_less, mid + 1, lo)
        hi = torch.where(live & b_less, mid, hi)
    return lo


def merge_path_twin(cols: tuple, num_keys: int, tile: int = 64,
                    rows_per_thread: int = 8) -> tuple:
    """The kernel's merge path in torch, at a small ``tile``: the partition's
    co-ranks at every tile boundary, each tile's A and rev-B ranges
    gathered as the merge CTA loads them, each thread's co-rank inside its
    tile (threads of ``rows_per_thread`` rows), its serial merge (A first
    on equal keys) recording each output row's source, and the gather.
    Returns new lanes; for the CPU tests of the kernel's index arithmetic."""
    _check(tuple(cols), num_keys, MIN_BLOCK)
    N = cols[0].shape[0]
    h = N // 2
    if tile & (tile - 1) or not rows_per_thread <= tile <= N or tile % rows_per_thread:
        raise ValueError(f"tile={tile} with {rows_per_thread} rows a thread")
    lanes = list(cols)
    keys = lanes[:num_keys]
    full = torch.full((), h, dtype=torch.int64)

    def a_key(i):
        return _key_at(keys, i.clamp(max=h - 1))

    def b_key(j):  # rev-B's row j is row N - 1 - j
        return _key_at(keys, N - 1 - j.clamp(max=h - 1))

    # partition: splits[t] = co-rank of t · tile
    d = torch.arange(0, N + 1, tile, dtype=torch.int64)
    splits = _corank(d, full.expand_as(d), full.expand_as(d), a_key, b_key)
    T = N // tile
    a0, na = splits[:-1], splits[1:] - splits[:-1]  # [T]
    b0 = N - 1 - (d[:-1] - a0)  # rev-B's first row of each tile, read downwards
    r = torch.arange(tile, dtype=torch.int64)
    rows = torch.where(r < na[:, None], a0[:, None] + r, b0[:, None] - (r - na[:, None]))
    sm = [c[rows] for c in lanes]  # [T, tile] each: the CTA's shared rows
    skeys = sm[:num_keys]
    # each thread's co-rank inside its tile, then its serial merge
    P = tile // rows_per_thread
    td = (torch.arange(P, dtype=torch.int64) * rows_per_thread).expand(T, P)
    tna, tnb = na[:, None].expand(T, P), (tile - na)[:, None].expand(T, P)
    tt = torch.arange(T)[:, None].expand(T, P)

    def sa_key(i):
        return [k[tt, i.clamp(max=tile - 1)] for k in skeys]

    def sb_key(j):
        return [k[tt, (tna + j).clamp(max=tile - 1)] for k in skeys]

    i = _corank(td, tna, tnb, sa_key, sb_key)
    j = td - i
    src = torch.empty((T, tile), dtype=torch.int64)
    for k in range(rows_per_thread):
        take_a = (j >= tnb) | ((i < tna) & ~_less(sb_key(j), sa_key(i)))
        src[:, k::rows_per_thread] = torch.where(take_a, i, tna + j)
        i, j = i + take_a, j + ~take_a
    return tuple(torch.gather(c, 1, src).reshape(N) for c in sm)


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
