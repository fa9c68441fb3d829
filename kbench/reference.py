"""Plain reference of a count job, in torch, from the generated reads.

It shares no code with the program.  The semantics are the reference
counter's (maruscia/fastkmer):

* a window of k bases counts when all k are A, C, G or T;
* its canonical form is the smaller, in A < C < G < T order, of the window
  and its reverse complement;
* its signature is the least normalised m-mer over its k - m + 1 m-mers,
  where an m-mer normalises to the smaller of itself and its reverse
  complement, each counted only when "allowed" (no AA anywhere, not
  starting ACA) and 4^m otherwise;
* its bin is the signature through Thomas Wang's 32-bit hash, masked to 31
  bits, modulo B = min(4^m, max_b);
* a k-mer is W = ceil(k / 16) uint32 words, base 0 in the high bits of
  word 0, the last word padded with zero bits.

Keys are carried as "pair keys": two words (w0, w1) in one int64 as
(w0 - 2^31) * 2^32 + w1, whose signed order is the order of the pair; an
odd last word rides alone.  Every operation is elementwise, a sort or a
prefix sum, on the device of the reads.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import NamedTuple

import numpy as np
import torch

HALF = 1 << 31
WORD = 1 << 32
M32 = WORD - 1
ASCII = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


class Table(NamedTuple):
    words: torch.Tensor  # [U, W] int64 holding uint32 values, ascending k-mers
    counts: torch.Tensor  # [U] int64


def n_pairs(k: int) -> int:
    return -(-k // 32)


def _word(codes: torch.Tensor, k: int, w: int, reverse: bool) -> torch.Tensor:
    """Word w of every window of every read, forward or reverse complement:
    [n, P] int64.  Invalid codes count as A here; their windows are masked."""
    n, L = codes.shape
    P = L - k + 1
    v = torch.zeros((n, P), dtype=torch.int64, device=codes.device)
    for j in range(16):
        pos = 16 * w + j
        v.mul_(4)
        if pos < k:
            src = k - 1 - pos if reverse else pos
            c = codes[:, src:src + P].to(torch.int64) & 3
            v.add_(3 - c if reverse else c)
    return v


def _strand_keys(codes: torch.Tensor, k: int, reverse: bool) -> list:
    W = -(-k // 16)
    keys = []
    for p in range(n_pairs(k)):
        hi = _word(codes, k, 2 * p, reverse)
        if 2 * p + 1 < W:
            hi.sub_(HALF).mul_(WORD).add_(_word(codes, k, 2 * p + 1, reverse))
        keys.append(hi)
    return keys


def valid_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[n, P] bool: the window holds no N."""
    n, L = codes.shape
    bad = torch.zeros((n, L + 1), dtype=torch.int32, device=codes.device)
    torch.cumsum(codes >= 4, dim=1, out=bad[:, 1:])
    return (bad[:, k:] - bad[:, :-k]) == 0


def canonical_keys(codes: torch.Tensor, k: int) -> list:
    """The pair keys of every valid window's canonical k-mer, flattened in
    read order: a list of [N] int64, most significant first."""
    fw = _strand_keys(codes, k, reverse=False)
    rc = _strand_keys(codes, k, reverse=True)
    le = fw[-1] <= rc[-1]
    for p in reversed(range(len(fw) - 1)):
        le = (fw[p] < rc[p]) | ((fw[p] == rc[p]) & le)
    valid = valid_windows(codes, k)
    return [torch.where(le, f, r)[valid] for f, r in zip(fw, rc)]


def lexsort(keys: list) -> torch.Tensor:
    """Permutation that sorts rows by keys[0], then keys[1], ..."""
    perm = None
    for key in reversed(keys):
        _, idx = torch.sort(key if perm is None else key[perm], stable=True)
        perm = idx if perm is None else perm[idx]
    return perm


def run_starts(sorted_keys: list) -> torch.Tensor:
    """Indices where a new key starts in lexicographically sorted keys."""
    n = sorted_keys[0].shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    if n:
        new[0] = True
        for key in sorted_keys:
            new[1:] |= key[1:] != key[:-1]
    return torch.nonzero(new).squeeze(1)


def words_of(keys: list, k: int) -> torch.Tensor:
    """Pair keys -> [U, W] int64 words."""
    W = -(-k // 16)
    cols = []
    for p, key in enumerate(keys):
        if 2 * p + 1 < W:
            hi = torch.div(key, WORD, rounding_mode="floor")
            cols += [hi + HALF, key - hi * WORD]
        else:
            cols.append(key)
    return torch.stack(cols, 1)


def _table(keys: list, weights: torch.Tensor | None, k: int) -> Table:
    """Rows (pair keys, with weights or one each) -> their table."""
    perm = lexsort(keys)
    keys = [key[perm] for key in keys]
    starts = run_starts(keys)
    ends = torch.cat([starts[1:], starts.new_tensor([keys[0].shape[0]])])
    if weights is None:
        counts = ends - starts
    else:
        csum = torch.cat([weights.new_zeros(1), torch.cumsum(weights[perm], 0)])
        counts = csum[ends] - csum[starts]
    return Table(words_of([key[starts] for key in keys], k), counts)


def count(codes: torch.Tensor, k: int) -> Table:
    """The exact table of canonical k-mers of the reads ([n, len] codes)."""
    return _table(canonical_keys(codes, k), None, k)


FINGERPRINT_PRIME = (1 << 31) - 1


def count_fingerprinted(codes: torch.Tensor, k: int) -> Table:
    """The control: the same count keyed by a 31-bit fingerprint of each
    canonical k-mer instead of the k-mer itself.  K-mers whose
    fingerprints collide merge into the first one met, so the table is no
    longer exact."""
    keys = canonical_keys(codes, k)
    fp = torch.zeros_like(keys[0])
    for key in keys:
        fp = (fp * 1000003 + torch.remainder(key, FINGERPRINT_PRIME)) % FINGERPRINT_PRIME
    order = torch.sort(fp, stable=True).indices
    fp = fp[order]
    starts = run_starts([fp])
    ends = torch.cat([starts[1:], starts.new_tensor([fp.shape[0]])])
    reps = [key[order][starts] for key in keys]
    return _table(reps, ends - starts, k)


def codes_of(words: torch.Tensor, k: int) -> torch.Tensor:
    """[U, W] words -> [U, k] uint8 codes."""
    pos = torch.arange(k, device=words.device)
    shift = 2 * (15 - pos % 16)
    return ((words[:, pos // 16] >> shift) & 3).to(torch.uint8)


def _allowed(c: list) -> torch.Tensor:
    """An m-mer given as m code columns is allowed: no AA, no ACA prefix."""
    ok = ~((c[0] == 0) & (c[1] == 1) & (c[2] == 0)) if len(c) >= 3 else None
    for a, b in zip(c[:-1], c[1:]):
        pair = ~((a == 0) & (b == 0))
        ok = pair if ok is None else ok & pair
    return ok


def _value(c: list) -> torch.Tensor:
    v = torch.zeros_like(c[0], dtype=torch.int64)
    for col in c:
        v = v * 4 + col
    return v


def signatures(words: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """The minimizer signature of each k-mer: [U] int64."""
    codes = codes_of(words, k).to(torch.int64)
    none = 4**m
    sig = None
    for j in range(k - m + 1):
        fw = [codes[:, j + t] for t in range(m)]
        rc = [3 - col for col in reversed(fw)]
        norm = torch.minimum(
            torch.where(_allowed(fw), _value(fw), none),
            torch.where(_allowed(rc), _value(rc), none),
        )
        sig = norm if sig is None else torch.minimum(sig, norm)
    return sig


def wang_hash_bin(sig: torch.Tensor, B: int) -> torch.Tensor:
    """Thomas Wang's 32-bit integer hash of the signature, masked to 31
    bits, modulo B."""
    key = sig & M32
    key = (key ^ 61) ^ (key >> 16)
    key = (key + (key << 3)) & M32
    key = key ^ (key >> 4)
    key = (key * 0x27D4EB2D) & M32
    key = key ^ (key >> 15)
    return (key & 0x7FFFFFFF) % B


def bins(words: torch.Tensor, k: int, m: int, B: int) -> torch.Tensor:
    return wang_hash_bin(signatures(words, k, m), B)


# -- output bytes -----------------------------------------------------------


class Text(NamedTuple):
    data: np.ndarray  # every line of every bin, bins in ascending order
    spans: dict  # bin id -> (offset, length) in data


def render_text(words: torch.Tensor, counts: torch.Tensor, bin_ids: torch.Tensor,
                k: int) -> Text:
    """The lines ``<KMER>\\t<count>\\n`` of every bin file, k-mers ascending
    within a bin (the EOF sentinel is not in ``data``)."""
    dev = words.device
    order = torch.sort(bin_ids, stable=True).indices
    w, c, b = words[order], counts[order].to(torch.int64), bin_ids[order]
    nd = torch.ones_like(c)
    for e in range(1, 19):
        nd += (c >= 10**e).to(torch.int64)
    D = int(nd.max()) if c.numel() else 1
    width = k + 2 + D
    mat = torch.zeros((c.shape[0], width), dtype=torch.uint8, device=dev)
    mat[:, :k] = ASCII.to(dev)[codes_of(w, k).long()]
    mat[:, k] = ord("\t")
    pow10 = torch.tensor([10**e for e in range(19)], dtype=torch.int64, device=dev)
    for t in range(D + 1):
        exp = nd - 1 - t
        digit = (c // pow10[exp.clamp(min=0)]) % 10 + ord("0")
        col = torch.where(exp >= 0, digit, torch.where(exp == -1, ord("\n"), 0))
        mat[:, k + 1 + t] = col.to(torch.uint8)
    keep = torch.arange(width, device=dev)[None, :] < (k + 2 + nd)[:, None]
    data = mat[keep].cpu().numpy()
    line = (k + 2 + nd)
    uniq, per_bin = torch.unique_consecutive(b, return_counts=True)
    csum = torch.cumsum(line, 0)
    ends = torch.cumsum(per_bin, 0) - 1
    stop = csum[ends].tolist()
    start = [0] + stop[:-1]
    return Text(data, {int(i): (s, e - s) for i, s, e in zip(uniq.tolist(), start, stop)})


def bin_bytes(text: Text, b: int) -> bytes:
    off, n = text.spans[b]
    return text.data[off:off + n].tobytes() + b"EOF"


def table_checksum(words: np.ndarray, counts: np.ndarray) -> str:
    """sha256 of the words as uint32 rows, then the counts as int64."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(words, dtype=np.uint32).tobytes())
    h.update(np.ascontiguousarray(counts, dtype=np.int64).tobytes())
    return h.hexdigest()


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def expected_manifest(job, words: np.ndarray, counts: np.ndarray, bin_ids: np.ndarray,
                      text: Text | None, npz_sha: str | None) -> dict:
    """The manifest the output directory must carry, without ``config``;
    ``npz_sha`` is the sha256 of the binary output's counts.npz."""
    uniq, per_bin = np.unique(bin_ids, return_counts=True)
    man = {
        "n_unique": int(words.shape[0]),
        "n_instances": int(counts.sum()),
        "checksum": table_checksum(words, counts),
        "bins": {str(int(b)): int(n) for b, n in zip(uniq, per_bin)},
    }
    if job.binary:
        man["binary"] = True
        man["extra_files"] = {"counts.npz": npz_sha}
    else:
        man["bin_sha256"] = {str(b): hashlib.sha256(bin_bytes(text, b)).hexdigest()
                             for b in text.spans}
    return man


def write_output(out_dir: str, job, words: torch.Tensor, counts: torch.Tensor,
                 bin_ids: torch.Tensor, config: dict) -> None:
    """Write a table as a count job would (the control's output, and the
    tests' known-good directories)."""
    os.makedirs(out_dir, exist_ok=True)
    hw = words.cpu().numpy().astype(np.uint32)
    hc = counts.cpu().numpy().astype(np.int64)
    hb = bin_ids.cpu().numpy().astype(np.int32)
    text = npz = None
    if job.binary:
        npz = os.path.join(out_dir, "counts.npz")
        np.savez_compressed(npz, words=hw, counts=hc, bins=hb, k=np.int32(job.k))
    else:
        text = render_text(words, counts, bin_ids, job.k)
        for b in text.spans:
            with open(os.path.join(out_dir, f"bin{b}"), "wb") as f:
                f.write(bin_bytes(text, b))
    npz_sha = file_sha256(npz) if npz else None
    man = {"config": config, **expected_manifest(job, hw, hc, hb, text, npz_sha)}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(man, f, indent=2)
