"""Stage-1 extract: the hand-written CUDA kernels and their wrappers.

* ``extract_sentinel`` (count mode) replaces
  ``fastkmer_tpu.ops.pallas_extract.extract_pallas_sentinel`` (the Pallas
  ``_mk_kernel(mode="count")``) and, through ``flag_lane``, the jnp
  ``pipeline._batch_extract_keys_flagged`` for k % 16 == 0.  Its plain
  version is ``extract_sentinel_reference``; ``LAUNCHES`` counts launches.
* ``extract_full`` (full mode) replaces ``extract_pallas`` (the Pallas
  ``_mk_kernel(mode="full")``), the mesh's stage-1 extractor.  Its plain
  version is ``extract.extract``; ``FULL_LAUNCHES`` counts launches.

Both kernels live in ``csrc/extract.cu``; its header says what bounds them
and how they are tiled.  A wrapper launches its kernel for a CUDA tensor
and raises if the launch fails; only for a CPU tensor does it run the plain
version.  The counters let a run show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.bits import num_words
from ..utils import cudabuild
from . import extract

LAUNCHES = 0
FULL_LAUNCHES = 0

# count mode: shared memory per block is kTile + k - 1 bytes; stay under the
# 48 KB a block gets without an opt-in attribute
_MAX_K = 48 * 1024 - 256 + 1
# full mode: (kTile + k - 1) + 4·(kTile + k - m) bytes, 2.5 KB at k = 256;
# k is held to the Pallas kernel's own bound (extract_pallas asserts k <= 256)
_MAX_K_FULL = 256


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cudabuild.load("fkextract", ("extract.cu",))
    lib.fk_extract_count.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fk_extract_count.restype = ctypes.c_int
    lib.fk_extract_full.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
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
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = library().fk_extract_count(
        codes.data_ptr(), R, L, k, int(flag_lane), out.data_ptr(),
        codes.device.index or 0, stream,
    )
    if err:
        raise RuntimeError(f"extract kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return tuple(out.unbind(0))


def extract_full(codes: torch.Tensor, k: int, m: int, B: int) -> extract.Extracted:
    """[R, L] uint8 codes -> ``extract.Extracted`` over the R·P window
    starts (P = L - k + 1, index r·P + i): words [R·P, W] int32, bins int32
    in [0, B) at every position, sigs int32, valid bool.  ``valid`` agrees
    with the plain version ``extract.extract`` everywhere; words, sigs and
    bins agree where valid.  4 <= m <= 15, m < k <= 256."""
    global FULL_LAUNCHES
    _check_codes(codes, k, _MAX_K_FULL)
    if not 4 <= m <= 15 or m >= k:
        raise ValueError(f"m={m} outside [4, min(15, k - 1)]")
    if not 1 <= B < 1 << 31:
        raise ValueError(f"B={B} outside [1, 2^31)")
    if codes.device.type == "cpu":
        return extract.extract(codes, k, m, B)
    R, L = codes.shape
    P = L - k + 1
    W = num_words(k)
    out = torch.empty((W + 3, R * P), dtype=torch.int32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = library().fk_extract_full(
        codes.data_ptr(), R, L, k, m, B, out.data_ptr(), codes.device.index or 0, stream,
    )
    if err:
        raise RuntimeError(f"full-mode extract kernel launch failed: CUDA error {err}")
    FULL_LAUNCHES += 1
    return extract.Extracted(
        words=out[:W].t(), bins=out[W], sigs=out[W + 1], valid=out[W + 2].bool(),
    )
