"""Multisequence k-mer counting with pairwise distances — the port of
``fastkmer_tpu.multiseq.pipeline`` (the reference's
``SparkMultiSequenceKmerCounter``).

Reads carry a sequence id; per-bin counting produces per-(k-mer, sequence)
counts; every distinct k-mer updates all pairwise distances with
``partial(c[s1], c[s2])``; the count output per bin is the per-k-mer SUM
over sequences, in the single-sequence output format.  As in the JAX
package, the pair loop is s2 in (s1, S) (the reference overran by one),
sequence names come from each record's own header, and the distances are
aggregated and written to ``distances.json``.

The sequence id rides as ONE EXTRA KEY LANE through the sort-count engine:
runs become (k-mer, seq) pairs, so counting reuses ``count_sort`` and the
``DeviceAccumulator`` unchanged.  The lane holds the id on valid windows and
all-ones (-1) on invalid ones; ``count_sort`` orders lanes as unsigned
32-bit values, so within a k-mer rows ascend by sequence id and the
sentinel sorts last, and a valid row is never all-ones (ids < 2^31), so the
lane keeps the sentinel unambiguous at every k.  Stage 1 is kernel A (the
count-mode extract, ``ops.cuda_extract.extract_sentinel``) at every k: at
k % 16 == 0 its flag lane gives validity and is then replaced by the seq
lane, so the table has W + 1 lanes, as JAX's does.

The pairwise accumulation runs on the host over the final table
(``accumulate_distances``); ``device=True`` takes the masked block Gram on
the card instead (``_pair_sums_from_device``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import NamedTuple

import numpy as np
import torch

from .. import pipeline as base
from ..config import JobConfig
from ..core.bits import num_words
from ..ingest import batch as batching
from ..ingest import fasta
from ..ingest.prefetch import prefetched
from ..ops import binhash, count_sort, cuda_extract
from ..output import manifest as manifest_mod
from ..output import writer
from ..utils.timing import StageTimer, fenced_span
from . import distances as dist_mod


@dataclasses.dataclass
class MultiseqConfig(JobConfig):
    """MultisequenceTestConfiguration equivalent
    (reference: multisequence/package.scala:25-35)."""

    distance_measure: str = "multisequence.SquaredEuclidean"


class MultiseqResult(NamedTuple):
    words: np.ndarray  # [U, W] unique canonical k-mers (ascending)
    seqs: np.ndarray  # [U] sequence id per row (k-mer repeats per seq)
    counts: np.ndarray  # [U] int64
    bins: np.ndarray  # [U] int32
    sequence_names: list
    distances: dict  # (name1, name2) -> float, ordered pairs per symmetry
    n_instances: int
    timings: dict
    exchange_bytes: int = 0  # mesh runs: bytes each shard sends, summed
    balance: dict | None = None  # mesh runs: LPT pre-pass stats
    n_batches: int = 0  # code batches read (resumed ones included)


def _batch_extract_keys_seq(codes: torch.Tensor, seq_ids: torch.Tensor, k: int, m: int,
                            B: int) -> tuple:
    """Stage 1 of the accumulator path: kernel A's W pre-sentineled word
    lanes plus the seq lane (the row's id on valid windows, -1 on invalid
    ones); no per-batch sort.  codes [R, L] uint8 and seq_ids [R] int32 on
    one device -> W + 1 int32 lanes of R·(L - k + 1) rows."""
    W = num_words(k)
    flagged = not count_sort.sentinel_safe_for(k)
    cols = cuda_extract.extract_sentinel(codes, k, m, B, flag_lane=flagged)
    # validity from the flag lane (0 on valid rows) or the all-ones sentinel
    valid = cols[W] == 0 if flagged else cols[W - 1] != -1
    R, L = codes.shape
    seq = seq_ids.to(torch.int32)[:, None].expand(R, L - k + 1).reshape(-1)
    return tuple(cols[:W]) + (torch.where(valid, seq, -1),)


def _batch_count_seq(codes: torch.Tensor, seq_ids: torch.Tensor, k: int, m: int, B: int):
    """The host path's per-batch count of (k-mer, seq) pairs -> host
    (words [U, W + 1] uint32, counts int64, bins int32), bins from the
    k-mer lanes.  The lanes arrive pre-sentineled, so they are counted by
    ``count_presentineled`` (JAX's ``count_sorted`` with sentinel_safe)."""
    W = num_words(k)
    sc = count_sort.count_presentineled(list(_batch_extract_keys_seq(codes, seq_ids, k, m, B)))
    idx = torch.nonzero(sc.is_uniq).squeeze(1)
    words = sc.words[idx]
    return base.table_to_host(words, sc.counts[idx],
                              binhash.bins_from_words(words[:, :W], k, m, B))


# float64 elements of one chunk's same-group mask (512 MB)
_PAIR_CHUNK_ELEMS = 1 << 26


def _pair_sums(gid: torch.Tensor, seqs: torch.Tensor, counts: torch.Tensor, S: int,
               measure: dist_mod.DistanceMeasure, T: int = 2048) -> torch.Tensor:
    """D[a, b] = sum over same-k-mer ordered row pairs (i, j) of
    f(c_i) * g(c_j) at [seq_i, seq_j], for the measure's row terms (f, g):
    the Gram accumulation of ``bilinear_terms`` without the dense
    [groups, S] matrix.  gid [N] int32 (-1 on padding), seqs [N] int32,
    counts [N] float64, N a multiple of T, on one device -> [S, S] float64.

    Rows arrive sorted by (k-mer, seq) with (group, seq) unique, so a group
    spans at most S consecutive rows.  Each T-row block sees a window of
    its rows plus an S-row halo on each side; the same-group mask
    Pm = (gid_block == gid_window) is exact there, and the block's S x S
    contribution is Fo.T @ (Pm @ Go), with Fo and Go the one-hot rows
    scaled by f and g.  Every ordered pair is anchored at its i row's
    block, so nothing is counted twice.  The blocks are batched (bmm) in
    chunks of about ``_PAIR_CHUNK_ELEMS`` mask elements.

    The matmuls run in float64, where the JAX package's run in float32: a
    float32 matmul on the card may run in TF32 (a 10-bit mantissa) under
    the process-wide setting, which breaks the 1e-4 agreement with the host
    once counts pass ~2^11, and the setting cannot be changed for one call
    (torch >= 2.9 raises once its legacy and new precision switches are
    mixed).  float64 is never TF32, and on an H100 its tensor-core rate
    equals float32's outside the tensor cores.

    Reference semantics: the pairwise accumulation of
    extractKXmersAndComputePartialDistances
    (SparkMultiSequenceKmerCounter.scala:446-520), reduced to matmuls."""
    N = gid.shape[0]
    nb = N // T
    dev = gid.device
    valid = gid >= 0
    # mask AFTER evaluation: padded rows have count 0, where f may be nan
    # (0 * log 0); torch.where selects the 0 branch regardless
    terms = [(torch.where(valid, f, 0.0).view(nb, T),
              torch.nn.functional.pad(torch.where(valid, g, 0.0), (S, S)).unfold(0, T + 2 * S, T))
             for f, g in measure.bilinear_row_terms(counts)]
    wgid = torch.nn.functional.pad(gid, (S, S), value=-1).unfold(0, T + 2 * S, T)
    wseq = torch.nn.functional.pad(seqs, (S, S)).unfold(0, T + 2 * S, T)
    cgid = gid.view(nb, T)
    cseq = seqs.view(nb, T)
    eye = torch.arange(S, dtype=seqs.dtype, device=dev)
    D = torch.zeros((S, S), dtype=torch.float64, device=dev)
    f64 = torch.float64
    chunk = max(1, _PAIR_CHUNK_ELEMS // (T * (T + 2 * S)))
    for b0 in range(0, nb, chunk):
        b = slice(b0, min(b0 + chunk, nb))
        cg = cgid[b]
        Pm = ((cg[:, :, None] == wgid[b][:, None, :]) & (cg[:, :, None] >= 0)).to(f64)
        c_hot = (cseq[b][:, :, None] == eye).to(f64)  # [blocks, T, S]
        w_hot = (wseq[b][:, :, None] == eye).to(f64)  # [blocks, T + 2S, S]
        for f, g in terms:
            Fo = f[b][:, :, None] * c_hot
            Go = g[b][:, :, None] * w_hot
            D += torch.bmm(Fo.transpose(1, 2), torch.bmm(Pm, Go)).sum(0)
        del Pm, c_hot, w_hot
    return D


def _pair_sums_from_device(gid, seqs, counts, S, measure, T: int = 2048,
                           device="cuda") -> np.ndarray:
    """Host shim for the device Gram: pad the table to a T granule
    (gid -1 rows contribute 0), ship the three thin columns once (N·16
    bytes, against the dense [groups, S] blocks the host path builds), run
    ``_pair_sums`` on ``device``, pull back one [S, S] matrix."""
    assert S <= T, (S, T)
    dev = base.resolve_device(device)
    N = gid.shape[0]
    Np = -(-N // T) * T
    g = np.full(Np, -1, np.int32)
    g[:N] = gid
    sq = np.zeros(Np, np.int32)
    sq[:N] = seqs
    c = np.zeros(Np, np.float64)
    c[:N] = counts
    D = _pair_sums(torch.from_numpy(g).to(dev), torch.from_numpy(sq).to(dev),
                   torch.from_numpy(c).to(dev), S, measure, T)
    return D.cpu().numpy()


def accumulate_distances(
    words: np.ndarray,
    seqs: np.ndarray,
    counts: np.ndarray,
    S: int,
    measure: dist_mod.DistanceMeasure,
    device=None,
) -> np.ndarray:
    """D[a, b] = sum over distinct k-mers of partial(c_a, c_b), rows sorted
    by (k-mer, seq).

    Identity used (both paths): with tot_a = sum_k partial(c_a, 0) over all
    k-mers present in a (and tot_b the 0-left analogue),

        D[a, b] = tot_a[a] + tot_b[b]
                + sum over same-k-mer present pairs of
                  h(c_a, c_b) = partial(c_a,c_b) - partial(c_a,0) - partial(0,c_b)

    When the measure decomposes h bilinearly (bilinear_terms), the pair sum
    is blocked dense [groups, S] count matrices reduced by F.T @ G Gram
    matmuls — O(U*S) BLAS flops, no pairwise sweep; otherwise the generic
    neighbor-offset sweep below handles arbitrary plug-in measures.

    ``device`` None or False (the default, as in the JAX package) runs on
    the host; True runs the pair sums on the card (``_pair_sums_from_device``,
    float64 matmuls: the host's result but for summation order), a device
    name on that device.  It applies to sum measures with
    ``bilinear_row_terms``.
    """
    U = words.shape[0]
    D = np.zeros((S, S), np.float64)
    if U == 0:
        if measure.operator_kind != "sum":
            D[:] = measure.init_distance()
            np.fill_diagonal(D, 0.0)
        return D
    counts = counts.astype(np.float64)
    kchange = np.empty(U, dtype=bool)
    kchange[0] = True
    np.any(words[1:] != words[:-1], axis=1, out=kchange[1:])
    gid = np.cumsum(kchange) - 1  # k-mer group id per row

    # --- operator-generic fold (non-additive distanceOperator plug-ins,
    # DistanceMeasure.java:16-40): every identity below is a SUM
    # decomposition, so non-sum measures take the direct fold the
    # reference merge loop performs (d = op(d, partial(c1, c2)) per
    # distinct k-mer, SparkMultiSequenceKmerCounter.scala:474-482): dense
    # [g, S] count blocks, partial evaluated on [g, S, S], folded with the
    # operator.  O(G*S^2) — the reference's own cost for these measures. ---
    if measure.operator_kind != "sum":
        D[:] = measure.init_distance()
        starts = np.flatnonzero(kchange)
        bounds = np.append(starts, U)
        n_groups = starts.size
        group_block = max(1, (1 << 18) // max(S * S, 1))
        for b0 in range(0, n_groups, group_block):
            b1 = min(b0 + group_block, n_groups)
            lo, hi = bounds[b0], bounds[b1]
            C = np.zeros((b1 - b0, S), np.float64)
            C[gid[lo:hi] - b0, seqs[lo:hi]] = counts[lo:hi]
            Pm = measure.partial(C[:, :, None], C[:, None, :])  # [g, S, S]
            if measure.operator_kind == "product":
                D *= np.prod(Pm, axis=0)
            else:
                for g in range(Pm.shape[0]):  # ordered left fold
                    D = measure.operator(D, Pm[g])
        np.fill_diagonal(D, 0.0)
        return D

    has_row = (
        type(measure).bilinear_row_terms
        is not dist_mod.DistanceMeasure.bilinear_row_terms
    )
    if device is not None and device is not False and has_row:
        D = _pair_sums_from_device(gid, seqs, counts, S, measure,
                                   device="cuda" if device is True else device)
        zero = np.zeros_like(counts)
        D += np.bincount(seqs, weights=measure.partial(counts, zero), minlength=S)[:, None]
        D += np.bincount(seqs, weights=measure.partial(zero, counts), minlength=S)[None, :]
        np.fill_diagonal(D, 0.0)
        return D

    if measure.bilinear_terms(np.zeros((0, S), np.float64)) is not None:
        starts = np.flatnonzero(kchange)  # entry index of each group start
        n_groups = starts.size
        bounds = np.append(starts, U)
        # ~8 MB float64 per dense block
        group_block = max(1, (1 << 20) // max(S, 1))
        for b0 in range(0, n_groups, group_block):
            b1 = min(b0 + group_block, n_groups)
            lo, hi = bounds[b0], bounds[b1]
            C = np.zeros((b1 - b0, S), np.float64)
            C[gid[lo:hi] - b0, seqs[lo:hi]] = counts[lo:hi]
            for F, G in measure.bilinear_terms(C):
                D += F.T @ G
        zero = np.zeros_like(counts)
        D += np.bincount(seqs, weights=measure.partial(counts, zero), minlength=S)[:, None]
        D += np.bincount(seqs, weights=measure.partial(zero, counts), minlength=S)[None, :]
        np.fill_diagonal(D, 0.0)
        return D

    # generic sweep: joint-present pairs via neighbor offsets within k-mer
    # groups (each group has <= S rows)
    joint_partial = np.zeros((S, S), np.float64)  # sum partial(ci, cj) over joint
    joint_single_a = np.zeros((S, S), np.float64)  # sum partial(ci, 0) over joint
    joint_single_b = np.zeros((S, S), np.float64)  # sum partial(cj, 0) over joint
    zeros = np.zeros(1, np.float64)
    for o in range(1, S):
        if o > U - 1:
            break
        same = gid[o:] == gid[:-o]
        if not same.any():
            continue
        a, b = seqs[:-o][same], seqs[o:][same]
        ca, cb = counts[:-o][same], counts[o:][same]
        np.add.at(joint_partial, (a, b), measure.partial(ca, cb))
        np.add.at(joint_partial, (b, a), measure.partial(cb, ca))
        np.add.at(joint_single_a, (a, b), measure.partial(ca, zeros))
        np.add.at(joint_single_a, (b, a), measure.partial(cb, zeros))
        np.add.at(joint_single_b, (a, b), measure.partial(zeros, cb))
        np.add.at(joint_single_b, (b, a), measure.partial(zeros, ca))

    # totals of one-sided terms over ALL rows of each sequence
    tot_a = np.zeros(S, np.float64)  # sum partial(c, 0)
    tot_b = np.zeros(S, np.float64)  # sum partial(0, c)
    np.add.at(tot_a, seqs, measure.partial(counts, np.zeros_like(counts)))
    np.add.at(tot_b, seqs, measure.partial(np.zeros_like(counts), counts))

    # D[a,b] = joint pairs + (a-only terms) + (b-only terms)
    D = joint_partial + (tot_a[:, None] - joint_single_a) + (tot_b[None, :] - joint_single_b)
    np.fill_diagonal(D, 0.0)
    return D


def _sequence_tag(header: str) -> str:
    """Sequence name from a read header: the leading word-character run,
    matching the reference's ``"(\\w+)."`` extraction
    (SparkMultiSequenceKmerCounter.scala:61-62) — SRA-style reads
    ``SRR197985.1``, ``SRR197985.2`` tag the same sequence ``SRR197985``.
    Chunk suffixes (``#i``) from long-mode splitting are stripped first."""
    head = header.split("#")[0]
    mobj = re.match(r"(\w+)", head)
    return mobj.group(1) if mobj else head.split()[0]


class SequenceTags:
    """Sequence ids in first-seen order of the reads' tags: ``names[i]`` is
    id i's name.  A resumed run reads the skipped batches too, so every
    name gets the id it had in the interrupted run."""

    def __init__(self):
        self.names: list[str] = []
        self._ids: dict[str, int] = {}

    def reads(self, cfg: JobConfig):
        """-> (sid, read) for every read of cfg.dataset."""
        for name, seq in fasta.iter_reads(cfg.dataset, cfg.sequence_type, cfg.k, cfg.read_len):
            tag = _sequence_tag(name)
            sid = self._ids.get(tag)
            if sid is None:
                sid = self._ids[tag] = len(self.names)
                self.names.append(tag)
            yield sid, seq


def pair_distances(words, seqs, counts, names: list, measure) -> dict:
    """The host distance accumulation over the final (k-mer, seq) table ->
    {(name1, name2): distance} for s1 < s2, and (name2, name1) too for an
    asymmetric measure (the reference's inclusive upper bound corrected)."""
    S = len(names)
    D = accumulate_distances(words, seqs, counts, S, measure) if S else np.zeros((0, 0))
    out = {}
    for s1 in range(S):
        for s2 in range(s1 + 1, S):
            out[(names[s1], names[s2])] = measure.finalize(float(D[s1, s2]), 0)
            if not measure.symmetric:
                out[(names[s2], names[s1])] = measure.finalize(float(D[s2, s1]), 0)
    return out


def execute_multiseq_job(
    cfg: MultiseqConfig,
    verbose: bool = True,
    device_accumulate: bool | None = None,
    unique_ub: int | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_interval: int = 32,
    keep_table: bool = False,
    device="cuda",
) -> MultiseqResult:
    """Single-device multiseq job: tagged dense row packing (one sequence a
    row, ``batch_codes_dense_tagged``), kernel A plus the seq lane, and the
    deferred ``DeviceAccumulator`` with one extra key lane, or the host
    path's per-batch counts and ``merge_partials``.  Reference semantics:
    SparkMultiSequenceKmerCounter.scala:300-547.

    ``device_accumulate`` defaults to the accumulator on CUDA and whenever
    ``unique_ub`` (a bound on distinct (k-mer, seq) PAIRS) is given.
    ``checkpoint_dir`` makes the run resumable as the count job is
    (output.manifest.BatchCheckpointer): the accumulator persists forced
    spills every ``checkpoint_interval`` batches, the host path every
    batch's part; spilled rows carry the seq lane, and the sequence names
    are rebuilt by reading the skipped batches.  ``keep_table`` writes the
    per-k-mer sums as the table.npz sidecar."""
    dev = base.resolve_device(device)
    timer = StageTimer()
    measure = dist_mod.get_measure(cfg.distance_measure)
    if verbose:
        print(cfg.describe())
    tags = SequenceTags()
    W = num_words(cfg.k)
    if device_accumulate is None:
        # unique_ub is an accumulator contract (sync-free feed)
        device_accumulate = unique_ub is not None or dev.type == "cuda"
    acc = (
        base.DeviceAccumulator(cfg.k, m=cfg.m, B=cfg.b, extra_lanes=1, unique_ub=unique_ub,
                               device=dev)
        if device_accumulate
        else None
    )
    parts = []
    ckpt = (
        manifest_mod.BatchCheckpointer(checkpoint_dir, checkpoint_interval)
        if checkpoint_dir
        else None
    )
    skip = 0
    if ckpt is not None:
        skip = ckpt.completed_batches()
        (acc.host_spills if acc is not None else parts).extend(ckpt.load_parts())
    batches = prefetched(
        batching.batch_codes_dense_tagged(tags.reads(cfg), cfg.reads_per_batch, cfg.read_len)
    )
    n_batches = 0
    with fenced_span(timer, "device_count", dev):
        for batch_idx, (codes, sids, _, _) in enumerate(batches):
            n_batches += 1
            if batch_idx < skip:
                continue  # counted before the interruption (names rebuilt)
            codes_t = torch.from_numpy(codes).to(dev)
            sids_t = torch.from_numpy(sids).to(dev)
            if acc is not None:
                acc.add_raw(_batch_extract_keys_seq(codes_t, sids_t, cfg.k, cfg.m, cfg.b))
                if ckpt is not None and (batch_idx + 1) % ckpt.interval == 0:
                    acc.spill()
                    ckpt.save_spills(batch_idx + 1, acc.host_spills)
            else:
                part = _batch_count_seq(codes_t, sids_t, cfg.k, cfg.m, cfg.b)
                parts.append(part)
                if ckpt is not None:
                    ckpt.save_batch(batch_idx, *part)

    with fenced_span(timer, "merge", dev):
        if acc is not None:
            words_ext, counts, bins = acc.finalize()
        else:
            words_ext, counts, bins = base.merge_partials(parts, W + 1)
    words = words_ext[:, :W]
    seqs = words_ext[:, W].astype(np.int32)

    with timer.span("distances"):
        pair_dist = pair_distances(words, seqs, counts, tags.names, measure)
    if cfg.write:
        with timer.span("write_output"):
            _write_multiseq_output(cfg, words, counts, bins, pair_dist, measure,
                                   keep_table=keep_table, timer=timer, device=dev)
    if ckpt is not None:
        ckpt.clear()  # the run completed
    return MultiseqResult(
        words, seqs, counts, bins, tags.names, pair_dist, int(counts.sum()), timer.as_dict(),
        n_batches=n_batches,
    )


def _write_multiseq_output(cfg, words, counts, bins, pair_dist, measure,
                           keep_table: bool = False, timer=None, device=None) -> None:
    """Bin files (per-k-mer SUM over sequences,
    SparkMultiSequenceKmerCounter.scala:487), or counts.npz for
    ``use_kryo_serializer`` (deflated on the card for a CUDA ``device``,
    with the count job's spans and counters on ``timer``), + distances.json + a manifest whose
    extra_files entry checksums the distances, so verify_output covers a
    multiseq directory completely.  ``keep_table`` writes the summed table
    as the sidecar: repair_output rewrites damaged bins from it without a
    recount (distances.json is verified, not repairable: it needs the
    per-seq table)."""
    uw, uc, ub = _sum_over_sequences(words, counts, bins)
    dpath = _write_distances(cfg.output_dir, pair_dist, measure)
    dist_extra = {"distances.json": manifest_mod.file_sha256(dpath)}
    cfg_dict = base.dataclasses_dict(cfg)
    if cfg.use_kryo_serializer:
        writer.write_binary_with_manifest(
            cfg.output_dir, cfg_dict, uw, uc, ub, cfg.k, extra_files=dist_extra, timer=timer,
            device=device,
        )
    else:
        hashes = writer.write_bin_files(cfg.output_dir, uw, uc, ub, cfg.k)
        manifest_mod.write_manifest(
            cfg.output_dir, cfg_dict, uw, uc, ub, extra_files=dist_extra, bin_hashes=hashes,
        )
    if keep_table:
        manifest_mod.write_table_sidecar(cfg.output_dir, uw, uc, ub)


def _sum_over_sequences(words, counts, bins):
    if words.shape[0] == 0:
        return words, counts, bins
    new = np.empty(words.shape[0], dtype=bool)
    new[0] = True
    np.any(words[1:] != words[:-1], axis=1, out=new[1:])
    starts = np.flatnonzero(new)
    return words[starts], np.add.reduceat(counts, starts), bins[starts]


def _write_distances(out_dir: str, pair_dist: dict, measure) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "distances.json")
    with open(path, "w") as f:
        json.dump(
            {
                "measure": measure.name,
                "symmetric": measure.symmetric,
                "distances": [
                    {"seq1": a, "seq2": b, "distance": d} for (a, b), d in pair_dist.items()
                ],
            },
            f,
            indent=2,
        )
    return path
