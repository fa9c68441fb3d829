"""Block sort: the hand-written CUDA kernel and its wrapper.

``sort_blocks`` replaces ``fastkmer_tpu.ops.pallas_sort.sort_blocks`` (the
Pallas ``_mk_block_sort_kernel`` / ``_stage`` bitonic network): every
consecutive ``block`` rows are sorted ascending, lexicographically over the
first ``num_keys`` lanes as unsigned 32-bit values, the other lanes riding
along.  Ties land in no particular order; each block keeps its multiset of
rows.  ``sort_blocks_`` sorts a [lanes, N] buffer in place.  Its plain
version is ``sort_blocks_reference``; ``LAUNCHES`` counts the kernel
launches (one per call).

The kernel lives in ``csrc/block_sort.cu``; its header says what bounds it
and how it keeps a block on chip.  ``stage_plan`` says, from the shape
alone, which route the kernel takes (one block per thread-block cluster,
or the tiled route for shapes no cluster holds) and where each stage of
the network runs; the wrapper launches what it says.  For a CUDA tensor
the wrapper launches the kernel or raises; only a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.tbits import pair_key
from ..utils import cudabuild

LAUNCHES = 0

# dynamic shared memory a Hopper CTA may opt into (227 KB)
SMEM_BYTES = 232448
MIN_BLOCK = 1024
# the cluster route: at most 8 CTAs (the portable cluster size) and 16 lanes
MAX_CLUSTER = 8
MAX_CLUSTER_LANES = 16


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cudabuild.load("fkblocksort", ("block_sort.cu",))
    lib.fk_sort_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fk_sort_blocks.restype = ctypes.c_int
    return lib


def tile_rows(lanes: int, block: int) -> int:
    """Rows the kernel sorts per CTA in shared memory: the largest power of
    two <= block whose ``lanes`` uint32 lanes fit in SMEM_BYTES."""
    tile = block
    while tile * lanes * 4 > SMEM_BYTES:
        tile //= 2
    if tile < MIN_BLOCK:
        raise ValueError(
            f"{lanes} lanes do not fit a {MIN_BLOCK}-row tile in {SMEM_BYTES} B of "
            "shared memory"
        )
    return tile


def rows_per_thread(lanes: int) -> int:
    """Rows a thread holds in registers on the cluster route (the kernel's
    ``rows_per_thread``: 16 up to 3 lanes, 8 up to 6, then 4)."""
    return 16 if lanes <= 3 else 8 if lanes <= 6 else 4


def pass_strides(lanes: int) -> int:
    """Strides one shared-memory pass of the cluster route runs (the
    kernel's ``pass_strides``): 3 up to 5 lanes, 2 up to 10, else 1."""
    return 3 if lanes <= 5 else 2 if lanes <= 10 else 1


class StagePlan(NamedTuple):
    """How the kernel sorts blocks of this shape.

    route: "cluster" (one block per thread-block cluster, one device-memory
        pass) or "tiled" (``tile``-row tiles, strides >= tile in device
        memory);
    cluster: CTAs per block on the cluster route, else 0;
    rows_per_cta: rows each CTA holds in shared memory (block / cluster, or
        tile);
    rows_per_thread: R, rows a lane holds in registers (cluster route): a
        warp's chunk of C = 32 R rows, lane ln holding rows ln·R + j
        (mapping Y: strides < R in the thread, R .. C/2 between lanes) or
        ln + 32 j (mapping X: strides 32 .. C/2 in the thread, used for
        klev > C);
    stages: (klev, s, where) in network order; where is "registers",
        "shuffle", "shared" or "cluster" (a shared-memory pass that reaches
        other CTAs) on the cluster route, "shared" or "device" on the tiled
        one;
    passes: the strides of each shared-memory pass of the cluster route,
        (klev, (s, s/2, ...)) in order: up to ``pass_strides`` strides from
        klev/2 down to C = 32 R, each pass loading its rows once.
    """

    route: str
    cluster: int
    rows_per_cta: int
    rows_per_thread: int
    stages: tuple
    passes: tuple = ()


def stage_plan(lanes: int, block: int) -> StagePlan:
    """The kernel's plan for ``lanes`` uint32 lanes and blocks of ``block``
    rows, from the shape alone."""
    if block < MIN_BLOCK or block & (block - 1):
        raise ValueError(f"block={block} is not a power of two >= {MIN_BLOCK}")
    klevs = [1 << e for e in range(1, block.bit_length())]
    cluster = _cluster_size(lanes, block, SMEM_BYTES // 2)  # two CTAs an SM
    if cluster > MAX_CLUSTER:
        cluster = _cluster_size(lanes, block, SMEM_BYTES)  # one CTA an SM
    if lanes <= MAX_CLUSTER_LANES and cluster <= MAX_CLUSTER:
        R = rows_per_thread(lanes)
        rc = block // cluster

        C = 32 * R  # rows of a warp's chunk
        ns = pass_strides(lanes)
        passes, top = [], {}
        for kl in klevs:
            big = [s for s in _strides(kl) if s >= C]
            for g in range(0, len(big), ns):
                passes.append((kl, tuple(big[g : g + ns])))
                top.update({(kl, s): big[g] for s in big[g : g + ns]})

        def where(kl: int, s: int) -> str:
            if s < R or (kl > C and 32 <= s < C):  # inside a thread (Y; X)
                return "registers"
            if s < C:  # between lanes (mapping Y)
                return "shuffle"
            return "shared" if top[kl, s] < rc else "cluster"

        stages = tuple((kl, s, where(kl, s)) for kl in klevs for s in _strides(kl))
        return StagePlan("cluster", cluster, rc, R, stages, tuple(passes))
    tile = tile_rows(lanes, block)
    stages = tuple((kl, s, "shared" if s < tile else "device")
                   for kl in klevs for s in _strides(kl))
    return StagePlan("tiled", 0, tile, 0, stages)


def _cluster_size(lanes: int, block: int, smem: int) -> int:
    """The fewest CTAs (a power of two) whose ``smem`` bytes each hold a
    block's lanes."""
    cluster = 1
    while lanes * block * 4 > cluster * smem:
        cluster *= 2
    return cluster


def _strides(klev: int) -> list:
    return [1 << e for e in reversed(range(klev.bit_length() - 1))]


def _check(cols: tuple, num_keys: int, block: int) -> None:
    if not 1 <= num_keys <= len(cols):
        raise ValueError(f"num_keys={num_keys} outside [1, {len(cols)}]")
    if block < MIN_BLOCK or block & (block - 1):
        raise ValueError(f"block={block} is not a power of two >= {MIN_BLOCK}")
    N = cols[0].shape[0]
    if N % block:
        raise ValueError(f"{N} rows are not a multiple of block={block}")
    for c in cols:
        if c.dtype != torch.int32 or c.shape != (N,) or c.device != cols[0].device:
            raise TypeError("lanes must be int32 [N] tensors on one device")


def sort_blocks_reference(cols: tuple, num_keys: int, block: int) -> tuple:
    """Plain torch version: per-block LSD passes of a stable
    ``torch.sort(dim=1)`` over int64 keys of two lanes each (the high lane
    sign-biased), then one gather per lane."""
    _check(cols, num_keys, block)
    N = cols[0].shape[0]
    blocked = [c.reshape(N // block, block) for c in cols]
    order = None
    for w in reversed(range(0, num_keys, 2)):
        hi = blocked[w]
        lo = blocked[w + 1] if w + 1 < num_keys else None
        if order is not None:
            hi = hi.gather(1, order)
            lo = None if lo is None else lo.gather(1, order)
        idx = torch.sort(pair_key(hi, lo), dim=1, stable=True).indices
        order = idx if order is None else order.gather(1, idx)
    return tuple(c.gather(1, order).reshape(N) for c in blocked)


def sort_blocks(cols: tuple, num_keys: int, block: int) -> tuple:
    """Sort each ``block`` of rows of the int32 [N] lanes ``cols`` (uint32
    bit patterns; N % block == 0, block a power of two >= 1024).  Returns new
    lanes; the inputs are not modified."""
    return sort_blocks_(torch.stack(tuple(cols)), num_keys, block)


def sort_blocks_(buf: torch.Tensor, num_keys: int, block: int) -> tuple:
    """``sort_blocks`` in place on a contiguous int32 [lanes, N] buffer, for
    a caller that builds its lanes there.  Returns the buffer's lanes."""
    global LAUNCHES
    if buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError("the buffer must be a contiguous [lanes, N] tensor")
    cols = buf.unbind(0)
    _check(cols, num_keys, block)
    dev = buf.device
    if dev.type == "cpu":
        buf.copy_(torch.stack(sort_blocks_reference(cols, num_keys, block)))
        return cols
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    plan = stage_plan(len(cols), block)
    if plan.route == "cluster" and buf.data_ptr() % 16:
        raise ValueError("the cluster route needs a 16-byte aligned buffer")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().fk_sort_blocks(
        buf.data_ptr(), buf.shape[1], len(cols), num_keys, block,
        plan.rows_per_cta, plan.cluster, dev.index or 0, stream,
    )
    if err:
        raise RuntimeError(f"block sort kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return cols
