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
and how a block larger than a CTA's shared memory is tiled.  For a CUDA
tensor the wrapper launches the kernel or raises; only a CPU tensor takes
the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.tbits import pair_key
from ..utils import cudabuild

LAUNCHES = 0

# dynamic shared memory a Hopper CTA may opt into (227 KB)
SMEM_BYTES = 232448
MIN_BLOCK = 1024


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cudabuild.load("fkblocksort", ("block_sort.cu",))
    lib.fk_sort_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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
    tile = tile_rows(len(cols), block)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().fk_sort_blocks(
        buf.data_ptr(), buf.shape[1], len(cols), num_keys, block, tile, dev.index or 0, stream,
    )
    if err:
        raise RuntimeError(f"block sort kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return cols
