"""Log-step sliding-window primitives on torch tensors — the port of
``fastkmer_tpu.ops.windows``.

Inputs and outputs are int64 tensors of unsigned 32-bit values (see
``core.tbits``).  Each primitive is O(log w) full-width passes.
"""

from __future__ import annotations

import torch

from ..core.tbits import M32


def rolling_pack(codes2: torch.Tensor, length: int) -> torch.Tensor:
    """codes2: [..., L] 2-bit values.  Returns [..., L-length+1] where
    out[..., i] packs codes2[i] .. codes2[i+length-1] big-endian (first base
    most significant).  Requires length <= 16."""
    assert 1 <= length <= 16
    L = codes2.shape[-1]
    assert L >= length
    pows = {1: codes2.to(torch.int64)}
    s = 1
    while s * 2 <= length:
        v = pows[s]
        n = v.shape[-1] - s
        pows[s * 2] = ((v[..., :n] << (2 * s)) | v[..., s : s + n]) & M32
        s *= 2
    out = None
    pos = 0
    take = L - length + 1
    for bit in reversed(range(5)):
        p = 1 << bit
        if length & p:
            sl = pows[p][..., pos : pos + take]
            out = sl if out is None else (((out << (2 * p)) | sl) & M32)
            pos += p
    return out


def window_min(a: torch.Tensor, w: int) -> torch.Tensor:
    """out[..., i] = min(a[..., i:i+w]) for i in 0..L-w."""
    assert w >= 1
    L = a.shape[-1]
    assert L >= w
    if w == 1:
        return a
    p = 1 << (w.bit_length() - 1)
    if p == w:
        p >>= 1
    g = a
    s = 1
    while s < p:
        n = g.shape[-1] - s
        g = torch.minimum(g[..., :n], g[..., s : s + n])
        s *= 2
    take = L - w + 1
    return torch.minimum(g[..., :take], g[..., w - p : w - p + take])


def window_any(mask: torch.Tensor, w: int) -> torch.Tensor:
    """out[..., i] = any(mask[..., i:i+w])."""
    return window_min((~mask).to(torch.int64), w) == 0
