"""Super-k-mer grouping and expansion — the port of
``fastkmer_tpu.ops.superkmer``.

Maximal runs of consecutive k-mers that share one minimizer signature ship
through the mesh exchange as one fixed-width record:

    payload: smax bases packed in smax/16 words (int32 bit patterns)
    n_kmers: run length (<= smax - k + 1)
    bin:     the shared signature's bin

Runs longer than ``smax - k + 1`` k-mers are split; both halves keep the
signature and bin, so counts never change.  ``expand`` rebuilds the
canonical k-mer words of every run on the receiving shard.

The JAX version finds each position's last run boundary with ``cummax`` and
the next one with a flipped ``cummin``.  Here both come from the boundaries'
ranks: a prefix sum numbers the boundaries, one scatter lists their
positions by rank, and a gather reads the previous or next one.  Column 0
of every row is a boundary, so a rank lookup never crosses a row, and the
next boundary after a row's last one is the next row's column 0, which is
that row's end in flat terms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import tbits
from ..core.bits import BASES_PER_WORD, num_words
from . import extract as ex_mod
from . import windows


class SuperKmers(NamedTuple):
    """Per-position super-k-mer starts, flattened over (read, position).

    payload:  [N, PW] int32 packed bases (uint32 bit patterns, PW = smax/16)
    n_kmers:  [N] int32 run length (0 where not a start)
    bins:     [N] int32 shared bin
    is_start: [N] bool this position starts a super-k-mer
    """

    payload: torch.Tensor
    n_kmers: torch.Tensor
    bins: torch.Tensor
    is_start: torch.Tensor


def payload_words(smax: int) -> int:
    if smax % BASES_PER_WORD:
        raise ValueError(f"smax={smax} must be a multiple of {BASES_PER_WORD}")
    return smax // BASES_PER_WORD


def _boundary_ranks(boundary: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """boundary [N] bool (True at index 0) -> (rank [N]: the index, in
    boundary order, of the last boundary at or before each position;
    pos [N + 1]: the flat position of each rank's boundary, N past the last)."""
    N = boundary.shape[0]
    rank = torch.cumsum(boundary, 0) - 1
    pos = torch.full((N + 2,), N, dtype=torch.int64, device=boundary.device)
    pos.scatter_(0, torch.where(boundary, rank, N + 1),
                 torch.arange(N, device=boundary.device))
    return rank, pos[: N + 1]


def group(codes: torch.Tensor, k: int, m: int, B: int, smax: int,
          ex: ex_mod.Extracted | None = None) -> tuple[SuperKmers, ex_mod.Extracted]:
    """Detect super-k-mer runs over a [R, L] uint8 code batch.

    Returns (SuperKmers, Extracted); ``ex`` takes a precomputed extraction
    of the same (codes, k, m, B), e.g. the full-mode kernel's output (the
    mesh step passes it).  Only ``sigs`` and ``valid`` at valid positions
    and ``bins`` at starts reach the result, so an extractor that differs
    from the plain one at invalid positions gives the same super-k-mers."""
    R, L = codes.shape
    P = L - k + 1
    cap = smax - k + 1  # max k-mers per record
    if cap < 1:
        raise ValueError(f"smax={smax} holds no {k}-mer")
    if ex is None:
        ex = ex_mod.extract(codes, k, m, B)
    dev = codes.device
    N = R * P
    sigs = ex.sigs.reshape(R, P)
    valid = ex.valid.reshape(R, P)
    boundary = torch.ones((R, P), dtype=torch.bool, device=dev)
    boundary[:, 1:] = (sigs[:, 1:] != sigs[:, :-1]) | (valid[:, 1:] != valid[:, :-1])
    boundary = boundary.reshape(N)
    idx = torch.arange(N, device=dev)

    # force a boundary where a run would exceed cap: distance since the last
    # natural boundary
    rank, pos = _boundary_ranks(boundary)
    dist = idx - pos[rank]
    boundary |= (dist % cap == 0) & (dist > 0)
    del rank, pos, dist
    is_start = boundary & ex.valid.reshape(N)

    # run length: next boundary (or the row end) minus own position
    rank, pos = _boundary_ranks(boundary)
    n_kmers = torch.where(is_start, pos[rank + 1] - idx, 0).to(torch.int32)
    del rank, pos, idx

    # payload: the next smax bases packed, at every position
    PW = payload_words(smax)
    ext = torch.cat([codes, codes.new_full((R, smax + BASES_PER_WORD), 4)], dim=1)
    p16 = windows.rolling_pack((ext & 3).to(torch.int64), 16)  # [R, L + smax + 1]
    del ext
    payload = torch.stack(
        [tbits.as_i32(p16[:, 16 * w : 16 * w + P]) for w in range(PW)], dim=-1
    )
    sk = SuperKmers(
        payload=payload.reshape(N, PW),
        n_kmers=n_kmers,
        bins=ex.bins.reshape(N),
        is_start=is_start,
    )
    return sk, ex


def _stitch(payload: torch.Tensor, base_off: torch.Tensor, nbases: int) -> torch.Tensor:
    """``nbases`` bases starting at each offset of ``base_off`` ([C] int64)
    from [S, PW] packed rows (int64 holding uint32 values), as one
    big-endian 32-bit value per (row, offset) with low zero padding: [S, C]."""
    PW = payload.shape[1]
    a = torch.div(base_off, BASES_PER_WORD, rounding_mode="floor")
    r2 = 2 * (base_off % BASES_PER_WORD)
    hi = (payload[:, a] << r2) & tbits.M32
    # the next word's leading bases; none past the last word, and a shift of
    # 32 leaves nothing of a value below 2^32 when r2 == 0
    lo = torch.where(a + 1 < PW, payload[:, torch.clamp(a + 1, max=PW - 1)], 0)
    v = hi | (lo >> (32 - r2))
    if nbases < BASES_PER_WORD:
        v = v & (tbits.M32 ^ ((1 << (2 * (BASES_PER_WORD - nbases))) - 1))
    return v


def expand(payload: torch.Tensor, n_kmers: torch.Tensor, bins: torch.Tensor, k: int,
           smax: int):
    """[S, PW] payloads -> (canonical k-mer words [S, C, W] int32, valid
    [S, C] bool, bins [S, C]), C = smax - k + 1 slots, slot j valid iff
    j < n_kmers.  Canonicalization matches ``extract.extract`` exactly.
    Vectorised over the C slots: one gather-and-shift pass per word."""
    S, PW = payload.shape
    if PW != payload_words(smax):
        raise ValueError(f"payload has {PW} words, smax={smax} needs {payload_words(smax)}")
    C = smax - k + 1
    W = num_words(k)
    rem = k - BASES_PER_WORD * (W - 1)
    dev = payload.device
    p = tbits.as_u32(payload)
    # reverse-complement payload: the RC of bases [j, j+k) is RC-string
    # bases [smax-j-k, smax-j), a forward stitch on rp
    rp = torch.stack([tbits.reverse16(p[:, PW - 1 - w] ^ tbits.M32) for w in range(PW)], dim=1)
    j = torch.arange(C, device=dev)
    use_rc = torch.zeros((S, C), dtype=torch.bool, device=dev)
    decided = torch.zeros_like(use_rc)
    fwd, rc = [], []
    for w in range(W):
        nb = rem if w == W - 1 else BASES_PER_WORD
        f = _stitch(p, j + 16 * w, nb)
        r = _stitch(rp, smax - k - j + 16 * w, nb)
        lt = r < f
        use_rc |= ~decided & lt
        decided |= lt | (r > f)
        fwd.append(tbits.as_i32(f))
        rc.append(tbits.as_i32(r))
        del f, r, lt
    del decided
    words = torch.empty((S, C, W), dtype=torch.int32, device=dev)
    for w in range(W):
        words[:, :, w] = torch.where(use_rc, rc[w], fwd[w])
        rc[w] = fwd[w] = None
    valid = j[None, :] < n_kmers[:, None]
    return words, valid, bins[:, None].expand(S, C)
