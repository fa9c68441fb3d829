"""Bit-level core on torch tensors — the port of ``fastkmer_tpu.core.jbits``.

torch's ``uint32`` has no shifts, add, compare or remainder, so every
function here computes in int64 holding unsigned 32-bit values
(0 <= x < 2^32) and returns int64 in that range.  Packed k-mer words travel
between ops as int32 tensors holding the uint32 bit pattern: ``as_u32``
widens them, ``as_i32`` narrows back (the cast keeps the low 32 bits).

All functions are elementwise and bit-exact against ``core.bits`` (numpy)
and ``core.jbits`` (jax).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
BIAS = 1 << 31


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 unsigned 32-bit values."""
    return x.to(torch.int64) & M32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 unsigned 32-bit values -> int32 tensor with the same bit pattern."""
    return x.to(torch.int32)


def _swap_fields(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit fields of 32-bit values held in int64."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def rc_mmers(v: torch.Tensor, m: int) -> torch.Tensor:
    """Reverse complement of 2-bit-packed m-mers (m <= 15)."""
    x = as_u32(v) ^ ((1 << (2 * m)) - 1)
    return _swap_fields(x) >> (32 - 2 * m)


def allowed_mask(v: torch.Tensor, m: int) -> torch.Tensor:
    """KMC2 allowed filter: no "AA" substring, no "ACA" prefix."""
    v = as_u32(v)
    y = v | (v >> 2)
    t = (y | (y >> 1)) & 0x55555555
    pairmask = 0x55555555 & ((1 << (2 * (m - 1))) - 1)
    no_aa = (t & pairmask) == pairmask
    if m >= 3:
        return no_aa & ((v >> (2 * m - 6)) != 0b000100)
    return no_aa


def norm_mmers(v: torch.Tensor, m: int) -> torch.Tensor:
    """norm(v) = min(v if allowed else 4^m, rc(v) if allowed else 4^m)."""
    sentinel = 1 << (2 * m)
    v = as_u32(v)
    rc = rc_mmers(v, m)
    sval = torch.where(allowed_mask(v, m), v, sentinel)
    rval = torch.where(allowed_mask(rc, m), rc, sentinel)
    return torch.minimum(sval, rval)


def hash_to_bucket(s: torch.Tensor, B: int) -> torch.Tensor:
    """Signature -> bin (the reference's int32 avalanche), as int32."""
    key = as_u32(s)
    key = (key ^ 61) ^ (key >> 16)
    key = (key + (key << 3)) & M32
    key = key ^ (key >> 4)
    key = (key * 0x27D4EB2D) & M32
    key = key ^ (key >> 15)
    return ((key & 0x7FFFFFFF) % B).to(torch.int32)


def reverse16(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit fields of each 32-bit value (no complement)."""
    return _swap_fields(as_u32(x))


def pair_key(hi: torch.Tensor, lo: torch.Tensor | None) -> torch.Tensor:
    """Order-preserving int64 sort key of one or two uint32 lanes (int32
    bits): the high lane sign-biased, so signed int64 order is unsigned
    (hi, lo) order."""
    h = hi.to(torch.int64)
    if lo is None:
        return h & M32
    return ((h ^ BIAS) << 32) | (lo.to(torch.int64) & M32)
