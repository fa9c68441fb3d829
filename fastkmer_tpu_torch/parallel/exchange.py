"""Distributed bin exchange on a device mesh — the port of
``fastkmer_tpu.parallel.exchange``.

The JAX mesh path is single-controller within a process: each process
holds its devices and runs each step through ``shard_map``.  The port keeps
that shape.  A ``Mesh`` is this process's ordered list of torch devices,
its rank and the world size; global shard ``rank * n_local + j`` is its
j-th (JAX's process-major device order), and the owner map indexes global
shards.  A batch (this rank's stripe of the global batch) is n_local
contiguous row stripes (``shard_batch``), and a step runs each local
shard's work in turn.  Within one process the all-to-all is block copies
between the shards' [n·cap] send buffers; when several shards share one
card (``make_mesh`` places shard i on ``cuda:{i % device_count()}``) those
copies stay in that card's memory.  Across ranks it is one
``all_to_all_single`` per lane dtype (``multihost.Collectives``), and the
step's drop and collision counters and the pre-pass histogram are summed
over the ranks, as JAX's psums do.  With one rank every function is the
single-process one.

One step, per shard: the full-mode extract (the CUDA kernel for a CUDA
shard, its plain version on the CPU) -> owner lookup -> ``route_by_owner``
into [n·cap] send buffers; then the exchange; then, per owner, a
``count_sorted`` of the received rows and the bins of its unique rows, or
with ``use_ht`` (useHT=1) a ``count_hashed`` whose collisions are totalled
over the shards.
Capacity overflow is counted, never silent: the step returns the total of
dropped rows so that the caller can retry with a larger ``cap``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.bits import num_words
from ..ops import binhash, count_hash, count_sort, cuda_extract, superkmer
from ..pipeline import resolve_device, table_to_host
from . import multihost

AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's ordered devices along the one mesh axis ``AXIS``, of a
    global mesh of ``world`` ranks; ``comm`` runs the cross-rank
    collectives (None in one process)."""

    devices: tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    comm: multihost.Collectives | None = None

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Global shard count."""
        return self.world * len(self.devices)

    @property
    def offset(self) -> int:
        """Global index of this rank's first shard."""
        return self.rank * len(self.devices)


def make_mesh(n: int, device="cuda") -> Mesh:
    """n shards on ``device``: on CUDA shard i lives on
    ``cuda:{i % torch.cuda.device_count()}``; on the CPU every shard does.
    Raises when CUDA is asked for and absent."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"mesh size {n} < 1")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        return Mesh(tuple(torch.device("cuda", i % count) for i in range(n)))
    return Mesh((dev,) * n)


class ShardCounts(NamedTuple):
    """Per-shard counting result: one list entry per shard, on its device.

    words:    [S, W] int32 sorted unique-run view (S = n·cap received slots,
              times C = smax - k + 1 for super-k-mer transport); under the
              HT engine the owner's unique rows alone, in k-mer order
    bins:     [S] int32, meaningful where is_uniq (0 elsewhere)
    is_uniq:  [S] bool
    counts:   [S] int32
    n_valid:  [] counted instances
    dropped:  [] total rows dropped by capacity overflow over every rank's
              shards, on the first shard's device
    collision: [] int32 shards of every rank that found a fingerprint
              collision (HT engine; 0 for the sort engine), on the first
              shard's device
    offset:   global index of the first (local) shard
    """

    words: list
    bins: list
    is_uniq: list
    counts: list
    n_valid: list
    dropped: torch.Tensor
    collision: torch.Tensor
    offset: int = 0


def route_by_owner(owner: torch.Tensor, valid: torch.Tensor, cols: tuple, n: int, cap: int,
                   fills: tuple | None = None):
    """Group local rows by destination shard into [n·cap] buffers.

    ``cols`` are 1-D tensors riding along; rows where ``valid`` is False are
    discarded.  Returns (routed cols tuple, ok int32 [n·cap] (1 on filled
    slots), n_dropped 0-d int64 = sum(max(hist - cap, 0))).  ``fills`` (one
    scalar per column, default 0) sets the unfilled slots.  Rows keep their
    input order inside a destination (a per-destination prefix sum ranks
    them; one scatter places them); the receiver sorts, so the order is free.
    """
    N = owner.shape[0]
    dev = owner.device
    key = torch.where(valid, owner.to(torch.int64), n)
    hist = torch.bincount(key, minlength=n + 1)[:n]
    rank = torch.zeros(N, dtype=torch.int64, device=dev)
    for d in range(n):
        sel = key == d
        rank = torch.where(sel, torch.cumsum(sel, 0) - 1, rank)
    keep = (key < n) & (rank < cap)
    dest = torch.where(keep, key * cap + rank, n * cap)  # n·cap: discard slot
    del key, rank, keep
    if fills is None:
        fills = (0,) * len(cols)
    routed = []
    for c, f in zip(cols, fills):
        buf = torch.full((n * cap + 1,), f, dtype=c.dtype, device=dev)
        buf.scatter_(0, dest, c)
        routed.append(buf[: n * cap])
    slot = torch.arange(n * cap, device=dev)
    ok = ((slot % cap) < hist[slot // cap]).to(torch.int32)
    return tuple(routed), ok, torch.clamp(hist - cap, min=0).sum()


def _all_to_all(bufs: list, mesh: Mesh, cap: int) -> list:
    """One process: bufs[s]: shard s's [n·cap] send lane -> one [n·cap]
    lane per shard: block s of shard d's lane is block d of shard s's."""
    return [
        torch.cat([b[d * cap : (d + 1) * cap].to(dev) for b in bufs])
        for d, dev in enumerate(mesh.devices)
    ]


def _exchange_ranks(mesh: Mesh, cap: int, send: list) -> list:
    """Across ranks: send[j]: local shard j's lanes, each [n·cap] with
    block g bound for global shard g -> recv[i]: local shard i's lanes,
    block s from global shard s.  One ``all_to_all_single`` per lane dtype
    moves [rank q, lane, source j, destination i, cap] blocks (the local
    ones included); the pack and the received blocks land on shard 0's
    card, and each received lane moves to its shard's card.  The send
    lanes are released as they are packed."""
    nl, p = mesh.n_local, mesh.world
    recv = [[None] * len(send[0]) for _ in range(nl)]
    groups: dict = {}
    for i, lane in enumerate(send[0]):
        groups.setdefault(lane.dtype, []).append(i)
    for idx in groups.values():
        first = send[0][idx[0]]
        pack = torch.empty((p, len(idx), nl, nl, cap), dtype=first.dtype, device=first.device)
        for a, i in enumerate(idx):
            for j in range(nl):
                pack[:, a, j].copy_(send[j][i].view(p, nl, cap))
                send[j][i] = None
        got = mesh.comm.all_to_all(pack)  # [source rank, lane, source j, destination i, cap]
        del pack
        for a, i in enumerate(idx):
            for d, dev in enumerate(mesh.devices):
                recv[d][i] = got[:, a, :, d].reshape(-1).to(dev)
    return recv


def _owner_tables(mesh: Mesh, owner_map: np.ndarray) -> list:
    tab = torch.from_numpy(np.asarray(owner_map, dtype=np.int64))
    return [tab.to(d) for d in mesh.devices]


def _exchange(mesh: Mesh, cap: int, send: list) -> list:
    """send[s]: local shard s's list of routed lanes -> recv[d]: local
    shard d's list of received lanes.  The send lanes are released as they
    are copied."""
    if mesh.world > 1:
        return _exchange_ranks(mesh, cap, send)
    per_lane = []
    for i in range(len(send[0])):
        per_lane.append(_all_to_all([s[i] for s in send], mesh, cap))
        for s in send:
            s[i] = None
    return [[lane[d] for lane in per_lane] for d in range(mesh.n_local)]


def _count_owned(words: torch.Tensor, valid: torch.Tensor, k: int, m: int, B: int):
    """Owner side: count the received rows and bin their unique k-mers.
    -> (words, bins, is_uniq, counts, n_valid); bins are computed only at
    the unique rows (the JAX step bins every slot; only unique rows are read)."""
    sc = count_sort.count_sorted(words, None, valid, sentinel_safe=count_sort.sentinel_safe_for(k))
    idx = torch.nonzero(sc.is_uniq).squeeze(1)
    bins = torch.zeros_like(sc.counts)
    bins[idx] = binhash.bins_from_words(sc.words[idx], k, m, B)
    return sc.words, bins, sc.is_uniq, sc.counts, sc.n_valid, None


def _count_owned_ht(words: torch.Tensor, valid: torch.Tensor, k: int, m: int, B: int):
    """Owner side of the HT engine: fingerprint-count the received rows.
    -> _count_owned's tuple over the unique rows alone, in k-mer order (the
    JAX step keeps fingerprint order, which its host merge of several
    batches then mistakes for k-mer order at W >= 3), and the collision
    flag."""
    sc, coll = count_hash.count_hashed(words, None, valid)
    uwords, counts = count_hash.unique_in_kmer_order(sc)
    is_uniq = torch.ones(counts.shape[0], dtype=torch.bool, device=counts.device)
    return (uwords, binhash.bins_from_words(uwords, k, m, B), is_uniq, counts, sc.n_valid,
            coll)


def _mesh_step(mesh: Mesh, cap: int, route, count):
    """step: list of this rank's per-shard code tensors -> ShardCounts.  On
    each shard ``route(s, codes)`` -> (send lanes, n_dropped); then the
    exchange; then on each owner ``count(received lanes)`` ->
    _count_owned's tuple.  ``count`` empties the lane list once it has read
    it, so the received lanes are freed before the owner's sort.  The drop
    and collision totals are summed over the ranks: every rank retries, or
    raises, on the same batch."""
    dev0 = mesh.devices[0]
    no_collision = torch.zeros((), dtype=torch.int32, device=dev0)

    def step(shards: list) -> ShardCounts:
        send, drops = [], []
        for s, codes in enumerate(shards):
            lanes, ndrop = route(s, codes)
            send.append(list(lanes))
            drops.append(ndrop)
            del lanes
        recv = _exchange(mesh, cap, send)
        per_shard = []
        for d in range(mesh.n_local):
            lanes, recv[d] = recv[d], None
            per_shard.append(count(lanes))
            del lanes
        words, bins, is_uniq, counts, n_valid, colls = map(list, zip(*per_shard))
        collision = no_collision if colls[0] is None else torch.stack(
            [c.to(dev0) for c in colls]).sum(dtype=torch.int32)
        dropped = torch.stack([d.to(dev0) for d in drops]).sum()
        if mesh.world > 1:
            dropped = mesh.comm.reduce(dropped)
            if colls[0] is not None:
                collision = mesh.comm.reduce(collision)
        return ShardCounts(
            words=words, bins=bins, is_uniq=is_uniq, counts=counts, n_valid=n_valid,
            dropped=dropped, collision=collision, offset=mesh.offset,
        )

    return step


def build_distributed_count(mesh: Mesh, k: int, m: int, B: int, cap: int,
                            owner_map: np.ndarray, use_ht: bool = False):
    """Returns step: list of per-shard [R/n, L] code tensors -> ShardCounts.

    Per-k-mer transport: each valid window's W canonical words travel to
    the owner of its bin.  When the sentinel is unambiguous (k % 16 != 0)
    invalid rows and unfilled slots carry the all-ones sentinel and no ok
    lane ships; otherwise the ok lane rides along.  ``cap`` is the
    per-(source, destination) row capacity.  ``use_ht`` counts on the owner
    with the HT engine (``_count_owned_ht``)."""
    n = mesh.size
    count_owned = _count_owned_ht if use_ht else _count_owned
    owner_tabs = _owner_tables(mesh, owner_map)
    sentinel_ok = count_sort.sentinel_safe_for(k)
    W = num_words(k)

    def route(s: int, codes: torch.Tensor):
        ex = cuda_extract.extract_full(codes, k, m, B)
        owner = owner_tabs[s][ex.bins]
        cols = tuple(ex.words[:, w] for w in range(W))
        if sentinel_ok:
            cols = tuple(torch.where(ex.valid, c, -1) for c in cols)
            routed, _, ndrop = route_by_owner(owner, ex.valid, cols, n, cap, fills=(-1,) * W)
            return routed, ndrop
        routed, ok, ndrop = route_by_owner(owner, ex.valid, cols, n, cap)
        return routed + (ok,), ndrop

    def count(lanes: list):
        rok = lanes[W - 1] != -1 if sentinel_ok else lanes[W] == 1
        words = torch.stack(lanes[:W], 1)
        lanes.clear()
        return count_owned(words, rok, k, m, B)

    return _mesh_step(mesh, cap, route, count)


def build_distributed_count_smer(mesh: Mesh, k: int, m: int, B: int, cap: int, smax: int,
                                 owner_map: np.ndarray, use_ht: bool = False):
    """Super-k-mer-transport variant of build_distributed_count.

    Ships fixed-width records (payload + run length) instead of k-mers and
    expands them on the owner: exchange bytes shrink by about the mean run
    length, and the owner's sort pays for the expansion padding (every
    record expands to C = smax - k + 1 slots, valid or not).  ``cap``
    counts records per (source, destination) pair; unfilled slots carry
    n_kmers = 0, so no ok lane ships.  ``use_ht`` as in
    build_distributed_count."""
    return _build_count_smer(mesh, k, m, B, cap, smax, owner_map, use_ht,
                             cuda_extract.extract_full)


def _build_count_smer(mesh: Mesh, k: int, m: int, B: int, cap: int, smax: int,
                      owner_map: np.ndarray, use_ht: bool, extract_fn):
    """build_distributed_count_smer with its stage-1 extractor
    ``extract_fn(codes, k, m, B) -> extract.Extracted`` as an argument: the
    public step passes kernel B's wrapper; ``smer_pallas_probe`` passes the
    plain ``extract.extract`` to time the step without the kernel."""
    n = mesh.size
    count_owned = _count_owned_ht if use_ht else _count_owned
    owner_tabs = _owner_tables(mesh, owner_map)
    PW = superkmer.payload_words(smax)

    def route(s: int, codes: torch.Tensor):
        ex = extract_fn(codes, k, m, B)
        sk, _ = superkmer.group(codes, k, m, B, smax, ex=ex)
        owner = owner_tabs[s][sk.bins]
        cols = tuple(sk.payload[:, w] for w in range(PW)) + (sk.n_kmers,)
        routed, _, ndrop = route_by_owner(owner, sk.is_start, cols, n, cap,
                                          fills=(-1,) * PW + (0,))
        return routed, ndrop

    def count(lanes: list):
        nk = lanes[PW]
        payload = torch.stack(lanes[:PW], 1)
        lanes.clear()
        kwords, kvalid, _ = superkmer.expand(payload, nk, torch.zeros_like(nk), k, smax)
        del payload, nk
        S, C, W = kwords.shape
        return count_owned(kwords.reshape(S * C, W), kvalid.reshape(S * C), k, m, B)

    return _mesh_step(mesh, cap, route, count)


def exchange_bytes_per_step(n: int, cap: int, k: int, smax: int | None = None) -> int:
    """Bytes each shard sends per step: W key lanes (W + 1 with the ok lane
    when k % 16 == 0) per row for k-mer transport, payload + n_kmers per
    record for super-k-mer transport."""
    if smax is None:
        lanes = num_words(k) + (0 if count_sort.sentinel_safe_for(k) else 1)
    else:
        lanes = superkmer.payload_words(smax) + 1
    return n * cap * lanes * 4


def estimate_bin_sizes(mesh: Mesh, k: int, m: int, B: int):
    """fn: list of this rank's per-shard code tensors -> int32 [B] global
    per-bin k-mer counts, summed over the ranks (on the first shard's
    device): the sampled LPT pre-pass."""
    dev0 = mesh.devices[0]

    def est(shards: list) -> torch.Tensor:
        total = torch.zeros(B, dtype=torch.int32, device=dev0)
        for codes in shards:
            ex = cuda_extract.extract_full(codes, k, m, B)
            total += count_sort.bin_histogram(ex.bins, ex.valid, B).to(dev0)
            del ex
        return mesh.comm.reduce(total) if mesh.world > 1 else total

    return est


def shard_batch(mesh: Mesh, codes: np.ndarray) -> list:
    """Split a host batch (this rank's [R/p, L] stripe of the global batch,
    or a per-row vector) into n_local contiguous row stripes, each on its
    shard's device.  Its rows must divide by n_local.  A CPU shard shares
    the numpy buffer, so the caller must not mutate ``codes`` afterwards."""
    n = mesh.n_local
    R = codes.shape[0]
    if R % n:
        raise ValueError(f"{R} rows do not split over {n} shards")
    t = torch.from_numpy(codes)
    r = R // n
    return [t[i * r : (i + 1) * r].to(d) for i, d in enumerate(mesh.devices)]


def compact_shard_counts(sc: ShardCounts, with_chips: bool = False) -> list:
    """ShardCounts -> per local shard (words uint32 [U, W], counts int64,
    bins int32) of its unique rows, in ascending order.  Compacts on the
    device and copies only the unique rows to the host.  ``with_chips``
    returns (global shard index, part) pairs: this rank's shards only, the
    counterpart of JAX's addressable shards."""
    out = []
    for chip, (w, b, u, c) in enumerate(zip(sc.words, sc.bins, sc.is_uniq, sc.counts),
                                        sc.offset):
        idx = torch.nonzero(u).squeeze(1)
        part = table_to_host(w[idx], c[idx], b[idx])
        out.append((chip, part) if with_chips else part)
    return out
