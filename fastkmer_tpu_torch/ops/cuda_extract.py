"""Stage-1 extract: the hand-written CUDA kernels and their wrappers.

* ``extract_sentinel`` (count mode) replaces
  ``fastkmer_tpu.ops.pallas_extract.extract_pallas_sentinel`` (the Pallas
  ``_mk_kernel(mode="count")``) and, through ``flag_lane``, the jnp
  ``pipeline._batch_extract_keys_flagged`` for k % 16 == 0.  Its plain
  version is ``extract_sentinel_reference``; ``LAUNCHES`` counts launches
  on both of its routes (``count_route``).  ``extract_count_twin`` is the
  staged route's own algorithm in torch (codes staged with their halo,
  16-mers packed at every position, prefix counts of invalid codes, the
  O(W) word pick), for the CPU tests; no path calls it.
* ``extract_full`` (full mode) replaces ``extract_pallas`` (the Pallas
  ``_mk_kernel(mode="full")``), the mesh's stage-1 extractor.  Its plain
  version is ``extract.extract``; ``FULL_LAUNCHES`` counts launches.
  ``extract_full_twin`` is the kernel's own algorithm in torch (the staged
  tile of the count-mode twin, plus the segmented window minimum), for the
  CPU tests; no path calls it.

Both kernels live in ``csrc/extract.cu`` and share its staged tile; its
header says what bounds them and how they are tiled.  A wrapper launches
its kernel for a CUDA tensor and raises if the launch fails; only for a CPU
tensor does it run the plain version.  The counters let a run show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import tbits
from ..core.bits import num_words
from ..utils import cudabuild
from . import cuda_sort, extract

LAUNCHES = 0
FULL_LAUNCHES = 0

# window starts per block of the staged kernels (csrc/extract.cu kStarts);
# count mode takes twice as many for k <= 32 (count_tile)
FULL_TILE = 1024


def count_tile(k: int) -> int:
    """Window starts per block of the staged count-mode kernel."""
    return 2 * FULL_TILE if k <= 32 else FULL_TILE


def _staged_bytes(tile: int, k: int) -> int:
    """Shared memory of a count-mode staged block (csrc/extract.cu
    StagedTile::bytes): fw, rw, the prefix counts and 8 scan totals in
    32-bit words, then the codes."""
    return 4 * (2 * (tile + k - 1) + (tile + k + 1) + 8) + tile + k + 14


# count mode, staged route: a block opts in past 48 KB of shared memory, up
# to the 227 KB a Hopper block can have (cuda_sort.SMEM_BYTES), and each
# base of k takes 13 bytes of it
_MAX_K_STAGED = (cuda_sort.SMEM_BYTES - _staged_bytes(FULL_TILE, 0)) // 13
# past it, up to _MAX_K, the byte route (count_route): a 256-start tile of
# 256 + k - 1 bytes, under the 48 KB a block gets without opting in
_MAX_K = 48 * 1024 - 256 + 1
# full mode: about 24·(FULL_TILE + k) bytes of shared memory, 32 KB at
# k = 256; k is held to the Pallas kernel's own bound (extract_pallas
# asserts k <= 256)
_MAX_K_FULL = 256


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cudabuild.load("fkextract", ("extract.cu",))
    for fn in (lib.fk_extract_count, lib.fk_extract_count_bytes):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.fk_extract_full.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.fk_extract_full.restype = ctypes.c_int
    return lib


def _check_codes(codes: torch.Tensor, k: int, max_k: int) -> None:
    if codes.dtype != torch.uint8 or codes.ndim != 2:
        raise TypeError(f"codes must be a 2-D uint8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if not 1 <= k <= max_k:
        raise ValueError(f"k={k} outside [1, {max_k}]")
    if codes.shape[1] < k:
        raise ValueError(f"read_len {codes.shape[1]} < k={k}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")


def _check(codes: torch.Tensor, k: int, flag_lane: bool) -> None:
    _check_codes(codes, k, _MAX_K)
    if k % 16 == 0 and not flag_lane:
        raise ValueError(
            "k % 16 == 0 needs flag_lane=True: an all-T k-mer equals the "
            "bare all-ones sentinel"
        )


def count_route(k: int) -> str:
    """The count-mode kernel that takes k: ``"staged"`` while a staged
    block's shared memory fits (k <= _MAX_K_STAGED), else ``"bytes"``."""
    return "staged" if k <= _MAX_K_STAGED else "bytes"


def extract_sentinel_reference(
    codes: torch.Tensor, k: int, m: int, B: int, flag_lane: bool = False
) -> tuple[torch.Tensor, ...]:
    """Plain torch version of the kernel (same outputs, any device)."""
    _check(codes, k, flag_lane)
    words, valid = extract.canonical_keys(codes, k)
    cols = tuple(torch.where(valid, words[:, w], -1) for w in range(words.shape[1]))
    if flag_lane:
        cols += (torch.where(valid, 0, -1).to(torch.int32),)
    return cols


def extract_sentinel(
    codes: torch.Tensor, k: int, m: int, B: int, flag_lane: bool = False
) -> tuple[torch.Tensor, ...]:
    """[R, L] uint8 codes -> W (+1 with ``flag_lane``) int32 columns, each
    [R·P], P = L - k + 1, index r·P + i: the canonical k-mer words of every
    window start, all-ones (-1) on windows with an invalid base; the flag
    lane is 0 on valid windows and -1 on invalid ones.  ``m`` and ``B`` are
    accepted for parity with the JAX signature; count mode needs neither."""
    global LAUNCHES
    _check(codes, k, flag_lane)
    if codes.device.type == "cpu":
        return extract_sentinel_reference(codes, k, m, B, flag_lane)
    R, L = codes.shape
    P = L - k + 1
    out = torch.empty((num_words(k) + int(flag_lane), R * P), dtype=torch.int32,
                      device=codes.device)
    lib = library()
    launch = lib.fk_extract_count if count_route(k) == "staged" else lib.fk_extract_count_bytes
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = launch(codes.data_ptr(), R, L, k, int(flag_lane), out.data_ptr(),
                 codes.device.index or 0, stream)
    if err:
        raise RuntimeError(f"extract kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return tuple(out.unbind(0))


def _check_full(codes: torch.Tensor, k: int, m: int, B: int) -> None:
    _check_codes(codes, k, _MAX_K_FULL)
    if not 4 <= m <= 15 or m >= k:
        raise ValueError(f"m={m} outside [4, min(15, k - 1)]")
    if not 1 <= B < 1 << 31:
        raise ValueError(f"B={B} outside [1, 2^31)")


def extract_full(codes: torch.Tensor, k: int, m: int, B: int) -> extract.Extracted:
    """[R, L] uint8 codes -> ``extract.Extracted`` over the R·P window
    starts (P = L - k + 1, index r·P + i): words [R·P, W] int32, bins int32
    in [0, B) at every position, sigs int32, valid bool.  ``valid`` agrees
    with the plain version ``extract.extract`` everywhere; words, sigs and
    bins agree where valid.  4 <= m <= 15, m < k <= 256."""
    global FULL_LAUNCHES
    _check_full(codes, k, m, B)
    if codes.device.type == "cpu":
        return extract.extract(codes, k, m, B)
    R, L = codes.shape
    P = L - k + 1
    W = num_words(k)
    out = torch.empty((W + 2, R * P), dtype=torch.int32, device=codes.device)
    valid = torch.empty(R * P, dtype=torch.uint8, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = library().fk_extract_full(
        codes.data_ptr(), R, L, k, m, B, out.data_ptr(), valid.data_ptr(),
        codes.device.index or 0, stream,
    )
    if err:
        raise RuntimeError(f"full-mode extract kernel launch failed: CUDA error {err}")
    FULL_LAUNCHES += 1
    return extract.Extracted(
        words=out[:W].t(), bins=out[W], sigs=out[W + 1], valid=valid.view(torch.bool),
    )


# --- the staged kernels' algorithm in torch (the CPU twins) ---------------------


def _stage(codes: torch.Tensor, k: int, tile: int) -> tuple[torch.Tensor, ...]:
    """Steps 1-3 of a staged kernel, one block per ``tile`` window starts of
    a row: the block's tile + k + 14 codes (code 4 past the row), the packed
    forward 16-mer fw[j] and its reverse complement rw[j] of every staged
    position j < tile + k - 1, and the exclusive prefix count cnt[j] of
    invalid codes in [0, j), j <= tile + k.  -> (fw, rw, cnt), int64
    [R, T, ·] for the T = ceil(P / tile) blocks of a row."""
    R, L = codes.shape
    T = -(-(L - k + 1) // tile)
    nF, nK, nC = tile + k - 1, tile + k + 1, tile + k + 14
    pos = (torch.arange(T)[:, None] * tile + torch.arange(nC)[None, :]).to(codes.device)
    ext = torch.cat([codes, codes.new_full((R, T * tile + nC - L), 4)], dim=1)
    staged = ext[:, pos]  # [R, T, nC]
    c2 = (staged & 3).to(torch.int64)
    fw = sum(c2[..., p : p + nF] << (2 * (15 - p)) for p in range(16))
    rw = sum((3 - c2[..., p : p + nF]) << (2 * p) for p in range(16))
    bad = (staged[..., : nK - 1] >= 4).to(torch.int64)
    cnt = torch.cat([torch.zeros_like(bad[..., :1]), bad.cumsum(-1)], dim=-1)
    return fw, rw, cnt


def _canonical(fw: torch.Tensor, rw: torch.Tensor, k: int, li: torch.Tensor) -> list:
    """Step 4: the W canonical words (int64) at each block start ``li``.
    Word w of the forward k-mer is fw[li + 16w], the last one masked; of the
    reverse complement rw[li + k - 16(w+1)], the last one from rw[li]; the
    first differing word picks the orientation."""
    W = num_words(k)
    rem = k - 16 * (W - 1)
    fwd = [fw[..., li + 16 * wd] for wd in range(W)]
    fwd[-1] = fwd[-1] & (tbits.M32 ^ ((1 << (32 - 2 * rem)) - 1))
    rc = [rw[..., li + k - 16 * (wd + 1)] for wd in range(W - 1)]
    rc.append(rw[..., li + k - 16 * W] if rem == 16
              else (rw[..., li] & ((1 << (2 * rem)) - 1)) << (32 - 2 * rem))
    use_rc = torch.zeros(fwd[0].shape, dtype=torch.bool, device=fw.device)
    decided = torch.zeros_like(use_rc)
    for f, r in zip(fwd, rc):
        use_rc |= ~decided & (r < f)
        decided |= r != f
    return [torch.where(use_rc, r, f) for f, r in zip(fwd, rc)]


def _flat(x: torch.Tensor, n: int) -> torch.Tensor:
    """[R, T, tile] per block start -> [R·n] per window start, n starts a
    row."""
    R = x.shape[0]
    return x.reshape(R, -1)[:, :n].reshape(R * n)


def extract_count_twin(
    codes: torch.Tensor, k: int, flag_lane: bool = False, tile: int | None = None
) -> tuple[torch.Tensor, ...]:
    """The staged count-mode kernel's algorithm in torch, one block per
    ``tile`` (default ``count_tile(k)``) window starts of a row: the staged
    codes with their halo, the packed 16-mers, the prefix count of invalid
    codes and the O(W) word pick.  Same outputs as ``extract_sentinel``."""
    _check(codes, k, flag_lane)
    tile = tile or count_tile(k)
    n = codes.shape[1] - k + 1
    fw, rw, cnt = _stage(codes, k, tile)
    li = torch.arange(tile, device=codes.device)
    valid = _flat(cnt[..., li + k] == cnt[..., li], n)
    cols = tuple(torch.where(valid, tbits.as_i32(_flat(w, n)), -1)
                 for w in _canonical(fw, rw, k, li))
    if flag_lane:
        cols += (torch.where(valid, 0, -1).to(torch.int32),)
    return cols


def extract_full_twin(
    codes: torch.Tensor, k: int, m: int, B: int, tile: int = FULL_TILE
) -> extract.Extracted:
    """The full-mode kernel's algorithm in torch: the count-mode twin's
    staged tile at ``tile`` starts, then the m-mer norms from the 16-mers
    and the van Herk window minimum over segments of k - m + 1 norms.  Same
    outputs as ``extract_full``; words at invalid windows are the
    kernel's too."""
    _check_full(codes, k, m, B)
    n = codes.shape[1] - k + 1
    fw, rw, cnt = _stage(codes, k, tile)
    nN = tile + k - m
    nrm = tbits.norm_mmers(fw[..., :nN] >> (32 - 2 * m), m)
    w = k - m + 1
    nseg = -(-nN // w)
    seg = torch.cat([nrm, nrm.new_full((*nrm.shape[:2], nseg * w - nN), 1 << 32)], dim=-1)
    seg = seg.view(*nrm.shape[:2], nseg, w)
    pre = seg.cummin(-1).values.view(*nrm.shape[:2], -1)
    suf = seg.flip(-1).cummin(-1).values.flip(-1).view(*nrm.shape[:2], -1)
    li = torch.arange(tile, device=codes.device)
    sigs = torch.minimum(suf[..., li], pre[..., li + w - 1])
    words = torch.stack([tbits.as_i32(_flat(x, n)) for x in _canonical(fw, rw, k, li)], dim=1)
    return extract.Extracted(
        words=words,
        bins=_flat(tbits.hash_to_bucket(sigs, B), n),
        sigs=_flat(sigs, n).to(torch.int32),
        valid=_flat(cnt[..., li + k] == cnt[..., li], n),
    )
