"""Device-memory pass probes: kernel E, its wrappers, and the probe script.

Replaces ``benchmarks/pallas_probe.py``, whose two Pallas kernels
(``copy_kernel`` and ``tr_kernel``, built inside its ``main``) are module
functions here:

* ``copy_pass(a, b)``: one streaming pass, each value + 1;
* ``transpose_pass(a, b)``: the same result through a transpose of each
  128 x 128 tile, the +1, and the transpose back (the lane <-> row swap a
  bitonic low pass performs).

Both take two int32 [N/128, 128] lanes holding uint32 bit patterns and
return new lanes equal to each input + 1, wrapping as uint32 does
(0xFFFFFFFF -> 0).  N is a multiple of 2^14, the Pallas copy's chunk (so
the rows are a multiple of the transpose's 128-row tile): the shapes the
Pallas grids run.  The kernels live in ``csrc/pass_probe.cu``; its header
says what bounds them.  For a CUDA tensor a wrapper launches its kernel or
raises; only CPU tensors take the plain version, ``pass_reference``.
``COPY_LAUNCHES`` and ``TRANSPOSE_LAUNCHES`` count launches.

The transpose's shared-memory layout is ``swizzle`` and its warps' 16-byte
accesses are ``transpose_accesses``, the same arithmetic as the kernel's,
so the CPU tests check that the layout is a bijection and that no access
waits on a bank conflict; ``transpose_twin`` runs the kernel's schedule
(load, T, S) on one tile in numpy.

    python -m fastkmer_tpu_torch.benchmarks.cuda_probe [lg] [--device cuda|cpu]

prints one JSON line per pass at 2^lg values a lane (default 24): the
host-clock ms of one call (ten calls, fenced), the effective GB/s (two lanes
read and written), and on the card the kernel's ms by CUDA events.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time

import numpy as np
import torch

from ..core.tbits import as_i32, as_u32
from ..pipeline import resolve_device
from ..utils import cudabuild
from ._common import device_name, emit, fence, log, rand_i32, time_ms

COPY_LAUNCHES = 0
TRANSPOSE_LAUNCHES = 0

LANES = 128  # the width of a row, as the Pallas probe shapes its columns
CHUNK = 1 << 14  # values a Pallas copy step takes; N must be a multiple
TILE = 128  # the transpose's tile is TILE x TILE values
TILE_CHUNKS = TILE // 4  # 16-byte chunks a tile row
TR_THREADS = 512  # threads of a transpose CTA


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    lib = cudabuild.load("fkpassprobe", ("pass_probe.cu",))
    for fn in (lib.fk_pass_copy, lib.fk_pass_transpose):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for x in (a, b):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES:
            raise TypeError(f"lanes must be int32 [N/{LANES}, {LANES}] tensors, got "
                            f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("lanes must be contiguous")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("the two lanes must have one shape and one device")
    if a.numel() % CHUNK:
        raise ValueError(f"N = {a.numel()} is not a multiple of {CHUNK} (rows a multiple "
                         f"of {CHUNK // LANES})")


def pass_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of either pass on one lane: x + 1 as uint32, computed in
    int64 and folded back to the int32 bit pattern."""
    return as_i32((as_u32(x) + 1) & 0xFFFFFFFF)


def _launch(entry: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    _check(a, b)
    dev = a.device
    if dev.type == "cpu":
        return pass_reference(a), pass_reference(b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("the lanes must be 16-byte aligned")
    oa, ob = torch.empty_like(a), torch.empty_like(b)
    err = getattr(library(), entry)(
        a.data_ptr(), b.data_ptr(), oa.data_ptr(), ob.data_ptr(), a.numel(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return oa, ob


def copy_pass(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(a + 1, b + 1) by one streaming pass (``copy_kernel``'s result)."""
    global COPY_LAUNCHES
    out = _launch("fk_pass_copy", a, b)
    if a.is_cuda:
        COPY_LAUNCHES += 1
    return out


def transpose_pass(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(a + 1, b + 1) through a transpose of each 128 x 128 tile, the touch
    and the transpose back (``tr_kernel``'s result)."""
    global TRANSPOSE_LAUNCHES
    out = _launch("fk_pass_transpose", a, b)
    if a.is_cuda:
        TRANSPOSE_LAUNCHES += 1
    return out


def swizzle(r, q):
    """Shared index (in 16-byte chunks) of chunk q of row r of a tile: the
    rows lie in order, and chunk q of row r at q ^ ((r >> 2) & 7) within its
    row (``swizzle`` in csrc/pass_probe.cu).  Works on ints and arrays."""
    return r * TILE_CHUNKS + (q ^ ((r >> 2) & 7))


def transpose_accesses() -> dict:
    """Each 16-byte shared-memory access pattern of ``transpose_pass``, as
    {name: [rows, chunks]} int arrays of [instructions, 32 lanes] for one
    warp (every warp's pattern is one of these up to the choice of J or L;
    all of them are listed):

    * ``load``: the cp.async copies, element e = k·512 + thread: row e / 32,
      chunk e % 32 (warp w, instruction k: row 16k + w);
    * ``T_read``: lane I reads block (I, J), rows 4I + i, chunk J;
    * ``T_write``: lane I writes block (J, I), rows 4J + j, chunk I;
    * ``S_read``: lane q reads block (q, L) of Y, rows 4q + i, chunk L."""
    lane = np.arange(32)
    out = {"load": [], "T_read": [], "T_write": [], "S_read": []}
    for w in range(TR_THREADS // 32):
        for k in range(TILE * TILE_CHUNKS // TR_THREADS):
            e = k * TR_THREADS + 32 * w + lane
            out["load"].append((e // TILE_CHUNKS, e % TILE_CHUNKS))
    for blk in range(TILE_CHUNKS):  # J in T, L in S
        for i in range(4):
            out["T_read"].append((4 * lane + i, np.full(32, blk)))
            out["T_write"].append((np.full(32, 4 * blk + i), lane))
            out["S_read"].append((4 * lane + i, np.full(32, blk)))
    return {k: [np.stack([r for r, _ in v]), np.stack([q for _, q in v])]
            for k, v in out.items()}


def bank_phases(rows: np.ndarray, chunks: np.ndarray, layout=swizzle) -> np.ndarray:
    """Shared-memory phases each 16-byte warp access takes under ``layout``
    (rows, chunks -> chunk index): a phase serves the eight lanes of a
    quarter warp (128 bytes), once more for each extra lane that falls in a
    16-byte bank group (4 banks) already taken.  [instructions, 32] ->
    [instructions]; 4 is the least."""
    group = layout(rows, chunks) % 8  # bank group: banks 4g .. 4g + 3
    q = group.reshape(group.shape[0], 4, 8)
    worst = np.stack([(q == g).sum(-1) for g in range(8)]).max(0)  # [instr, 4]
    return worst.sum(-1)


def transpose_twin(tile: np.ndarray) -> np.ndarray:
    """``transpose_pass`` on one [128, 128] uint32 tile, in numpy, as the
    kernel schedules it: the load into the swizzled X, T (each 4 x 4 block
    (I, J) of X transposed in registers, + 1, written to Y as block (J, I)),
    S (Y's block (q, L) transposed back, stored as chunk q of rows
    4L .. 4L + 3).  Returns the stored tile."""
    flat = tile.reshape(-1, 4)  # 16-byte chunks, row-major
    X = np.zeros_like(flat)
    Y = np.zeros_like(flat)
    e = np.arange(TILE * TILE_CHUNKS)
    X[swizzle(e // TILE_CHUNKS, e % TILE_CHUNKS)] = flat[e]
    lane = np.arange(32)
    for J in range(TILE_CHUNKS):
        m = np.stack([X[swizzle(4 * lane + i, J)] for i in range(4)], 1)  # [lane, i, j]
        for j in range(4):
            Y[swizzle(4 * J + j, lane)] = m[:, :, j] + np.uint32(1)
    out = np.zeros_like(flat)
    for L in range(TILE_CHUNKS):
        m = np.stack([Y[swizzle(4 * lane + i, L)] for i in range(4)], 1)
        for j in range(4):
            out[(4 * L + j) * TILE_CHUNKS + lane] = m[:, :, j]
    return out.reshape(TILE, TILE)


def run(lg: int = 24, device="cuda") -> list[dict]:
    """Both passes on two random [2^lg / 128, 128] lanes: one JSON line
    each, as the Pallas probe printed, with the kernel's CUDA-event ms on
    the card (None on the CPU)."""
    dev = resolve_device(device)
    log(f"device: {device_name(dev)}")
    N = 1 << lg
    gen = torch.Generator(dev).manual_seed(0)
    a = rand_i32(gen, N, dev).view(N // LANES, LANES)
    b = rand_i32(gen, N, dev).view(N // LANES, LANES)
    out = []
    for name, fn in (("copy_pass", copy_pass), ("transpose_pass", transpose_pass)):
        fn(a, b)
        fence(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            fn(a, b)
        fence(dev)
        dt = (time.perf_counter() - t0) / 10
        kernel_ms = time_ms(lambda: fn(a, b), 20) if dev.type == "cuda" else None
        out.append(emit(probe=name, device=device_name(dev), N=N, ms=dt * 1e3,
                        effective_GBps=2 * 2 * N * 4 / dt / 1e9, kernel_ms=kernel_ms))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("lg", nargs="?", type=int, default=24, help="log2 of the values a lane")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.lg, args.device)


if __name__ == "__main__":
    main()
