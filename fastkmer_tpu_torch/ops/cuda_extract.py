"""Count-mode stage-1 extract: the hand-written CUDA kernel and its wrapper.

Replaces ``fastkmer_tpu.ops.pallas_extract.extract_pallas_sentinel`` (the
Pallas ``_mk_kernel(mode="count")``) and, through ``flag_lane``, the jnp
``pipeline._batch_extract_keys_flagged`` for k % 16 == 0.  The kernel lives
in ``csrc/extract.cu``; its header says what bounds it and how it is tiled.

``extract_sentinel`` launches the kernel for a CUDA tensor and raises if the
launch fails; for a CPU tensor it runs the plain version
``extract_sentinel_reference``.  ``LAUNCHES`` counts kernel launches, so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fastkmer_tpu.core.bits import num_words

from ..utils import cudabuild
from . import extract

LAUNCHES = 0

# shared memory per block is kTile + k - 1 bytes; stay under the 48 KB a
# block gets without an opt-in attribute
_MAX_K = 48 * 1024 - 256 + 1


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = cudabuild.load("fkextract", ("extract.cu",))
    lib.fk_extract_count.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fk_extract_count.restype = ctypes.c_int
    return lib


def _check(codes: torch.Tensor, k: int, flag_lane: bool) -> None:
    if codes.dtype != torch.uint8 or codes.ndim != 2:
        raise TypeError(f"codes must be a 2-D uint8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k={k} outside [1, {_MAX_K}]")
    if codes.shape[1] < k:
        raise ValueError(f"read_len {codes.shape[1]} < k={k}")
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
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
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
