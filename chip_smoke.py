"""Smoke run of fastkmer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``fastkmer_tpu_torch/csrc`` (one nvcc per
source, started together) and drives the port's three paths: the
single-chip sort-engine count job, the per-batch mesh count job with
super-k-mer transport, and the streaming mesh counter (the default of
``--mesh N``); the HT engine on the single device and the mesh; resume,
repair and traces; the probe scripts (``fastkmer_tpu_torch.benchmarks``),
those that run kernels D and E and those of kernels A, B and C; multiseq
(``--multiseq``) on the single device and the streaming mesh; the mesh across processes
(``parallel.multihost`` on ``torch.distributed``); and the bench and entry
layer (the bench, ``entry()`` and the multichip dry run).  Each phase raises on
failure, so the process exits non-zero:

1. card: needs ``torch.cuda.is_available()``; prints nvidia-smi's name and
   power limit;
2. build: compiles the kernels with nvcc and prints the seconds taken and
   ptxas's registers and spill bytes for each kernel; the redesigned
   kernels (count- and full-mode extract, cluster block sort, the merge
   path's partition and merge, the pass probes) must spill nothing;
3. kernel vs plain: the count-mode extract kernel against its plain torch
   version on the card (``torch.equal``) for every listed (k, m), at
   [512, 4096] and a ragged [3, k+5]; at the edge shapes P = 2048 and
   4097 (k = 28: 2048 starts a block), P = 1024 and three full blocks with
   a long halo (1024 starts a block), k = 4, k = 256 with rows of k bases,
   the flag lane at k = 32 and 64, a block that opts in to more than 48 KB
   of shared memory (k = 3001), the largest staged k and the wrapper's
   largest k (the byte route), with Ns on the block boundaries;
   and at phase 5's [4096, 4096] for k in {28, 31, 32 (flag lane), 55, 97,
   155}, where both are timed with CUDA events beside the byte bound;
3b. full-mode kernel vs plain: ``extract_full`` against ``extract.extract``
   on the card for the same (k, m) and shapes: ``valid`` equal, words, sigs
   and bins equal where valid, bins in [0, B) everywhere; the same at the
   edge shapes k = m + 1, k = 256 with rows of k bases, and rows whose
   starts end on or just past the kernel's 1024-start blocks; both timed at
   [4096, 4096] for k in {28, 31, 55, 97, 155};
3c. block sort vs plain: ``cuda_sort.sort_blocks`` against
   ``sort_blocks_reference`` on the card for 1-4 keys, with and without a
   value lane, at blocks 1024, 8192 and 32768, and at 32768 for all-equal
   keys, mostly-sentinel blocks, 13 keys + 1 value and 15 keys + 1 value
   (the tiled route): keys equal (``torch.equal``) and each block's rows
   equal as a multiset;
4. slice parity: the CLI entry (``cli.main``) on a seeded ~4 Mbp FASTA
   with Ns, at k=28 and k=32, with ``--device cuda`` and ``--device cpu``;
   the output directories must be identical;
4b. mesh parity: ``cli.main --mesh 4 --smer-transport`` with LPT placement
   (``useCustomPartitioner=1 4``) on the first half of phase 4's reads at
   k=28 (cut in PR 10 for the run's time), with ``--device cuda`` (all
   four shards on ``cuda:0``) and ``--device cpu``: identical output
   directories, and bin files identical to the single device's on the
   same half;
4c. streaming mesh parity: ``cli.main --mesh 4`` (the streaming counter)
   with ``useCustomPartitioner=1 4`` on phase 4's FASTA: at k=28 cuda,
   cuda with ``FASTKMER_PALLAS_COMPACT=1`` (the block-sort compaction),
   cuda with ``--prededup on`` and cpu write identical directories whose
   bin files equal phase 4's; at k=32 cuda's bin files equal phase 4's;
5. real size: ``cli.main`` on 150-base reads at 16x coverage of a
   16,777,216-base random genome, k=28 m=10 x=3 B=2048, write=1,
   4096 x 4096 batches; checks the kernel launches against the batches the
   run made, the manifest, the instance count against the valid windows
   counted on the host, and the table's order;
5b. phase 5 again with ``FASTKMER_PALLAS_COMPACT=1``: bin files identical
   to phase 5's, and block-sort launches in the accumulator's merges;
6. the per-batch mesh at half depth: the first half of phase 5's reads
   (8x coverage) with phase 5's arguments, through the single device and
   ``cli.main --mesh 4 --smer-transport`` with ``useCustomPartitioner=1 4``,
   all four shards on one card: phase 5's checks, bin files identical to
   the single device's, and at least four full-mode launches per batch
   plus the pre-pass's (cut from phase 5's depth to keep the whole run near
   eight minutes);
7. the streaming mesh at real size: phase 5's FASTA and arguments through
   ``cli.main --mesh 4`` (streaming) with ``useCustomPartitioner=1 4``:
   phase 5's checks, bin files identical to phase 5's, at least four
   full-mode launches per batch plus the pre-pass's, and no block-sort
   launch;
7b. phase 7 with ``FASTKMER_PALLAS_COMPACT=1``: the same checks, and at
   least one block-sort launch per shard and merge; then, at the shape of
   one of its full merge windows, the block sort is held against its plain
   version as in phase 3c, and the kernel (in place, on a fresh unsorted
   copy each call), its plain version and ``torch.sort`` of the packed key
   (the library yardstick) are timed;
8. kernel E (``cuda_probe.copy_pass`` / ``transpose_pass``)
   against its plain version (``torch.equal``) at 2^14 and 2^24 values a
   lane, at 131 tiles a lane (uneven among the persistent transpose CTAs)
   and on lanes with 0xFFFFFFFF entries; the copy, the transpose,
   the plain version, the library's int32 ``a + 1`` on each lane (the
   same function) and the library's own transpose round trip (an extra
   yardstick) timed at 2^24;
9. kernel D (``cuda_bitonic_merge``, the merge path) against its plain
   version for 1-3 keys with and without a value lane at 2^11 (one tile),
   2^15 and 2^17 rows, at 2^17 for all-equal keys and mostly-sentinel
   halves, and at 2^16 for tiles wholly from A then B (and the reverse)
   and runs longer than a tile: keys equal to the plain version's and to
   the sorted keys, rows the same multiset, in place and out of place
   equal; then at 2^27 rows x 3 lanes (2 keys + 1 value, the split-merge
   probe's shape) the same checks, and the kernel's two launches (into a
   preallocated buffer and scratch), the in-place form (a fresh copy each
   call, the copy back included), its plain version and ``torch.sort`` of
   the packed key timed;
10. the probes on the card, each with the kernels' counts set to 0 just
   before it: ``split_merge_probe.run(27)`` (its exactness fields must
   hold), ``resume_merge_probe.run()`` and ``cuda_probe.run(24)``; their
   JSON lines are printed, and each must have launched its kernel; then
   ``multiseq_probe.run()`` (the accumulator with and without the seq
   lane, 8 batches of [4096, 4096], S = 8; kernel A must launch) and
   ``distance_probe.run()`` under SquaredEuclidean and KLDLog2 (device
   Gram against host Gram at S = 8, 64, 256; raises past 1e-4 relative);
   then the bench-layer probes at small sizes, each with the counts set
   to 0 before it and its kernel launched: ``e2e`` (A), ``mesh_dedup_probe``
   (B; its three arms' tables equal), ``merge_probe`` (C, in its
   block-sort arm; that merge equal to the default one), ``stream_probe``
   (A) and ``skew`` (B); then the probes of kernels A, B and C, each
   likewise: ``bigk_probe.run(R=64)`` (A at every k of its list; its
   plain arms launch no A, its kernel arms do, and the arms' counts are
   equal), ``smer_pallas_probe.run(iters=1, R=64)`` (B in its kernel arm
   only; the arms' tables equal, nothing dropped),
   ``pallas_sort_probe.run(20, [1 << 15])`` (C; exact on 2^18 rows) and
   ``scaling.run()`` (B; mesh sizes 1-8 on the card, nothing dropped);
11. the HT engine (useHT=1) on the single device at phase 5's workload:
   kernel A once a batch and B never, the manifest, the instance count,
   ascending files, and bin files equal to phase 5's with each trailing
   ``EOF`` dropped (a collision would raise); wall time, Gbp/s, spans and
   peak memory logged; then HT at k=55 (the murmur mix) and k=32 (the
   flag lane) on phase 4's FASTA, cuda and cpu directories identical;
12. HT on the per-batch mesh at phase 6's half depth (``--mesh 4``,
   ``useCustomPartitioner=1 4``; cut in PR 10 for the run's time): bin
   files equal to phase 6's single device's without ``EOF``, at least
   four kernel B launches a batch and none of A; then
   ``--smer-transport`` useHT=1 on phase 4b's half, cuda == cpu;
13. durability at phase 5's workload, each run interrupted after batch 10
   by a batch reader that raises and resumed by a fresh call on the same
   checkpoint directory (``--checkpoint-interval 4``), which must be empty
   afterwards: the single device's ``execute_job`` (the accumulator's
   spills; the directory byte-identical to phase 5's), the streaming mesh
   at phase 6's half depth, interrupted after batch 6 (since PR 10; bin
   files equal to phase 6's single device's), and HT through the per-batch flow with
   ``--keep-table`` (the directory phase 11's plus table.npz); then one
   bin of it corrupted and ``repair_output`` restores it byte for byte
   with no kernel launch; and ``--trace-dir`` on phase 4's FASTA writes a
   torch.profiler trace;
14. multiseq, small: 4 sequences (a 32768-base genome and three copies
   with 1% substitutions, headers ``S<s>.<i>``, 1000 150-base reads each,
   0.1% N) through ``cli.main --multiseq`` at k = 28, 32 and 55 under the
   three measures, cuda and cpu directories identical (bins,
   ``distances.json``, manifest) and kernel A at least once a batch at
   every k (k = 32 through its flag lane); ``--mesh 4
   useCustomPartitioner=1 4`` cuda == cpu, its bins and distances equal
   to the single device's, kernel B at least four times a batch; a run
   killed after batch 3 and resumed gives the uninterrupted directory;
   ``--prededup on`` without a mesh raises;
15. multiseq at real size on the single device: 8 sequences (a 2^21-base
   genome and seven copies with 1% substitutions), 150-base reads from
   both strands at 8x coverage of each, 0.1% N, grouped by sequence
   (134,217,728 bases), k=28 m=10 x=3 B=2048 write=1, 4096 x 4096
   batches, ``--unique-ub 16777216``: rc 0, the manifest verified, the
   instance count equal to the host's count of valid windows, kernel A at
   least once a batch, bin files byte-identical to the count job's on the
   same FASTA (run in the phase); ``accumulate_distances(device=True)`` on
   the run's table within 1e-4 relative of the host's under the three
   measures, with TF32 allowed process-wide; wall time, Gbp/s with and
   without ``write_output``, spans and peak memory logged;
16. phase 15's FASTA through ``--mesh 4 useCustomPartitioner=1 4`` (four
   shards on one card): bin files and ``distances.json`` identical to
   phase 15's, kernel B at least four times a batch; ``exchange_bytes``,
   balance, spans and peak memory logged;
17. the mesh across processes: 2 ranks started with the launcher's
   environment (as torchrun would), each with 2 of the 4 shards on the one
   card, so the backend is gloo (printed, with whether its
   ``all_to_all_single`` took the CUDA tensors); each rank zeroes its own
   kernels' counts and runs ``cli.main``.  (a) phase 7's FASTA and
   arguments on the streaming path: the union of the ranks' bin files in
   the shared directory byte-identical to phase 7's, the merged manifest
   verified, its ``n_unique`` / ``n_instances`` and each rank's
   ``exchange_bytes`` and step count equal to phase 7's, and the ranks'
   kernel B launches at least four a global batch plus the pre-pass's;
   (b) phase 4's FASTA through ``--smer-transport`` with enableKryo and a
   checkpoint directory a rank: the union of ``counts.part0/1.npz`` equal
   to phase 4's table, the manifest verified, the checkpoint directories
   emptied.  Each rank's wall time, peak device memory, spans and seconds
   in collectives are logged; a rank that fails or outlives its timeout
   fails the phase;
18. the bench and entry layer: ``fastkmer_tpu_torch.bench`` in its default
   mode at bench.py's full shapes (16 batches of [4096, 4096] from a
   2^24-base genome; the JSON line logged, its sanity checks held, kernel
   A at least once a batch), then every other mode on 4 batches of the
   dup workload (2^21-base genome), each table equal to the default
   mode's on those batches; ``entry.entry()`` on the card equal to
   ``entry("cpu")`` on the same codes and ``entry.dryrun_multichip(4)``
   (four shards on the card) equal to the CPU run's five numbers, each
   with kernel B launched;
19. the card's deflate of counts.npz (``deflate_phase``): the kernel's
   stream equal to the plain version's on each member kind, random bytes
   and zeros, in one piece and a piece a segment; ``write_binary`` on the
   card against the host path; at the benchmark cell's table shape the
   kernels' device time by CUDA events beside their bound, each array's
   first segments equal to the plain version's (its ms timed on them),
   the write's time and user CPU, its members read back, and the file's
   size against numpy's (at most 3% over); and phase 5's reads through the
   CLI with enableKryo=1, the deflate launched once a piece and the npz
   holding phase 5's table.

Phases 11-13 and 17 run after 7b, on its data; phase 7b's merge-window
timing and phases 8-10 follow them, then 14-16, then 18 and 19.  Each new phase logs its
seconds.  The script imports only the port (``fastkmer_tpu_torch``),
torch and numpy.

The line before the last is one JSON object with the six kernels'
launches (the deflate's: phase 19's pieces; D's: split_merge's and
resume_merge's summed; A's and B's also by phase, 14-18 included), errors,
times, bounds and shares of the bound (``bound_share`` = bound_ms / ms);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
EXTRACT_CASES = [(28, 10, False), (31, 8, False), (13, 4, False), (55, 9, False),
                 (97, 13, False), (155, 14, False), (32, 10, True), (64, 11, True)]
GENOME = 1 << 24
COVERAGE = 16
READ_LEN = 150
BASE_CODE = np.full(256, 4, np.uint8)  # ASCII -> 2-bit code, 4 = not ACGT
BASE_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
SORT_BLOCK = 1 << 15  # the merges' compaction block (pipeline._acc_merge)
COUNT_TIMED = [(28, False), (31, False), (32, True), (55, False), (97, False), (155, False)]
DEFLATE_ROWS = 4_770_000  # phase 19: the benchmark cell's distinct 55-mers


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def random_codes(rng, R: int, L: int, invalid: float = 0.01) -> np.ndarray:
    codes = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
    codes[rng.random((R, L)) < invalid] = 4
    return codes


def count_edge_codes(rng, k: int, R: int, L: int) -> np.ndarray:
    """Codes for a count-kernel edge shape: an all-T row, a row of exactly
    k bases, Ns on the 1024- and 2048-start block boundaries; past k = 256
    (where a window almost always holds an N at 1%) one N in row 2 only."""
    codes = random_codes(rng, R, L, 0.01 if k <= 256 else 0.0)
    codes[0] = 3
    codes[1, k:] = 4
    if k > 256:
        codes[2, L // 2] = 4
    codes[R - 1, 1023:1025] = 4
    codes[R - 1, 2047:2049] = 4
    return codes


def write_reads_fasta(path: str, reads: np.ndarray) -> None:
    """[n, len] codes (4 = N) -> FASTA with one record per row."""
    n, ln = reads.shape
    recs = np.empty((n, ln + 4), np.uint8)
    recs[:, :3] = np.frombuffer(b">r\n", np.uint8)
    recs[:, 3 : 3 + ln] = np.frombuffer(b"ACGTN", np.uint8)[reads]
    recs[:, -1] = ord("\n")
    recs.tofile(path)


def sample_reads(rng, genome: np.ndarray, n: int, n_rate: float) -> np.ndarray:
    """Reads from both strands of ``genome`` with ~n_rate Ns."""
    starts = rng.integers(0, genome.shape[0] - READ_LEN + 1, size=n)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    reads[rng.random(reads.shape) < n_rate] = 4
    return reads


def mutated_copies(rng, genome: np.ndarray, n: int, rate: float) -> list:
    """``genome`` and n - 1 copies of it, each with an independent ``rate``
    of point substitutions (a base replaced by one of the other three)."""
    out = [genome]
    for _ in range(n - 1):
        g = genome.copy()
        sub = rng.random(g.shape[0]) < rate
        g[sub] = (g[sub] + rng.integers(1, 4, size=int(sub.sum()), dtype=np.uint8)) % 4
        out.append(g)
    return out


def write_tagged_fasta(path: str, reads: list) -> None:
    """reads[s] = [n, len] codes (4 = N) of sequence s (s < 10) -> FASTA
    grouped by sequence, one record ``>S<s>.<i>`` (i zero-padded to seven
    digits) per row: the multiseq tag of each record is ``S<s>``."""
    with open(path, "wb") as f:
        for s, rs in enumerate(reads):
            n, ln = rs.shape
            recs = np.empty((n, 12 + ln + 1), np.uint8)
            recs[:, :4] = np.frombuffer(f">S{s}.".encode(), np.uint8)
            idx = np.arange(n)
            for p in range(7):
                recs[:, 10 - p] = ord("0") + idx // 10**p % 10
            recs[:, 11] = ord("\n")
            recs[:, 12:-1] = np.frombuffer(b"ACGTN", np.uint8)[rs]
            recs[:, -1] = ord("\n")
            recs.tofile(f)


def valid_windows(reads: np.ndarray, k: int) -> int:
    """Windows of k bases with no N, counted on the host."""
    bad = np.zeros((reads.shape[0], reads.shape[1] + 1), np.int16)
    np.cumsum(reads >= 4, axis=1, out=bad[:, 1:])
    return int(((bad[:, k:] - bad[:, :-k]) == 0).sum())


def dir_bytes(d: str) -> dict[str, bytes]:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def read_bin_table(out_dir: str, k: int, eof: bool = True):
    """Parse every bin file: -> (lines, sum of counts, all files strictly
    ascending).  Each file ends in ``EOF`` when ``eof`` (the sort engine)
    and in a newline otherwise (the HT engine).  k <= 32, so a k-mer packs
    into one uint64 key."""
    n_lines, total, ascending = 0, 0, True
    for name in os.listdir(out_dir):
        if not name.startswith("bin"):
            continue
        data = np.fromfile(os.path.join(out_dir, name), np.uint8)
        if eof:
            check(data[-3:].tobytes() == b"EOF", f"{name}: no EOF sentinel")
            data = data[:-3]
        else:
            check(data[-1] == ord("\n"), f"{name}: does not end in a newline")
        nl = np.flatnonzero(data == ord("\n"))
        starts = np.concatenate([[0], nl[:-1] + 1])
        check(bool((data[starts + k] == ord("\t")).all()), f"{name}: bad line layout")
        codes = BASE_CODE[data[starts[:, None] + np.arange(k)]].astype(np.uint64)
        check(bool((codes < 4).all()), f"{name}: non-ACGT k-mer")
        key = np.zeros(starts.shape[0], np.uint64)
        for j in range(k):
            key = (key << np.uint64(2)) | codes[:, j]
        ascending &= bool((key[1:] > key[:-1]).all())
        first = starts + k + 1
        nd = nl - first
        val = np.zeros(starts.shape[0], np.int64)
        for d in range(int(nd.max())):
            has = d < nd
            digit = data[np.where(has, first + d, 0)].astype(np.int64) - ord("0")
            val = np.where(has, val * 10 + digit, val)
        n_lines += starts.shape[0]
        total += int(val.sum())
    return n_lines, total, ascending


def same_bin_files(a: str, b: str) -> bool:
    """The bin* files of two output directories are byte-identical (read
    one pair at a time)."""
    names = sorted(n for n in os.listdir(a) if n.startswith("bin"))
    if names != sorted(n for n in os.listdir(b) if n.startswith("bin")):
        return False
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def same_bins_but_eof(sort_dir: str, ht_dir: str) -> bool:
    """The HT engine's bin files are the sort engine's with each trailing
    ``EOF`` dropped (read one pair at a time)."""
    names = sorted(n for n in os.listdir(sort_dir) if n.startswith("bin"))
    if names != sorted(n for n in os.listdir(ht_dir) if n.startswith("bin")):
        return False
    for n in names:
        with open(os.path.join(sort_dir, n), "rb") as fs, open(os.path.join(ht_dir, n), "rb") as fh:
            want = fs.read()
            if not want.endswith(b"EOF") or fh.read() != want[:-3]:
                return False
    return True


def manifest_bytes(out_dir: str) -> bytes:
    with open(os.path.join(out_dir, "manifest.json"), "rb") as f:
        return f.read()


def same_dir_as(out_dir: str, manifest: bytes, names: list, extra: tuple = ()) -> bool:
    """``out_dir`` holds ``names`` (plus ``extra``) and a manifest of the
    same bytes as ``manifest``, and every file it lists verifies: the
    manifest carries each bin's sha256, so the bin files are byte-identical
    to those it was written with."""
    from fastkmer_tpu_torch import api

    return (sorted(os.listdir(out_dir)) == sorted(list(names) + list(extra))
            and manifest_bytes(out_dir) == manifest and api.verify_output(out_dir)["ok"])


class Interrupted(Exception):
    """Raised by ``dying_reader``'s batch reader: the job dies mid-run."""


@contextlib.contextmanager
def dying_reader(call: int, at: int, reader_name: str = "batch_file"):
    """Inside the block, the port's batch reader (``ingest.batch.<reader_name>``:
    ``batch_file``, or multiseq's ``batch_codes_dense_tagged``) raises
    Interrupted when its ``call``-th use (0-based: a mesh's pre-pass reads
    the file first) is about to yield batch ``at``, after ``at`` batches
    went to the card."""
    from fastkmer_tpu_torch.ingest import batch as batching

    real = getattr(batching, reader_name)
    calls = [0]

    def reader(*args, **kw):
        c = calls[0]
        calls[0] += 1
        for i, item in enumerate(real(*args, **kw)):
            if c == call and i == at:
                raise Interrupted(f"batch {at}")
            yield item

    setattr(batching, reader_name, reader)
    try:
        yield
    finally:
        setattr(batching, reader_name, real)


def interrupt_and_resume(run, ck: str, call: int, cursor: int, tag: str, at: int = 10,
                         reader_name: str = "batch_file") -> tuple:
    """``run()`` dies after batch ``at`` (``dying_reader``), leaving a
    checkpoint at batch ``cursor`` in ``ck``; then a fresh ``run()`` resumes
    from it.  -> (the resumed run's result, its seconds, the interrupted
    run's seconds).  ``ck`` must be empty afterwards."""
    from fastkmer_tpu_torch.output import manifest

    t0 = time.perf_counter()
    try:
        with dying_reader(call, at, reader_name):
            run()
    except Interrupted:
        pass
    else:
        raise RuntimeError(f"{tag}: the run was not interrupted")
    t_die = time.perf_counter() - t0
    done = manifest.BatchCheckpointer(ck).completed_batches()
    check(done == cursor, f"{tag}: the checkpoint holds {done} batches, not {cursor}")
    t0 = time.perf_counter()
    res = run()
    t_resume = time.perf_counter() - t0
    check(os.path.isdir(ck) and not os.listdir(ck), f"{tag}: the checkpoint directory is not empty")
    return res, t_resume, t_die


def ptxas_kernels(report: str) -> dict[str, tuple[int, int, int]]:
    """ptxas -v report -> {mangled kernel: (registers, spill bytes, stack
    frame bytes)}."""
    out, fn, spill, stack = {}, None, 0, 0
    for line in report.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line):
            fn = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            stack, spill = int(m.group(1)), int(m.group(2)) + int(m.group(3))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out[fn] = (int(m.group(1)), spill, stack)
            spill = stack = 0
    return out


@contextlib.contextmanager
def block_sort_switch(on: bool):
    """FASTKMER_PALLAS_COMPACT=1 inside the block (the block-sort
    compaction), unset outside it."""
    if on:
        os.environ["FASTKMER_PALLAS_COMPACT"] = "1"
    try:
        yield
    finally:
        os.environ.pop("FASTKMER_PALLAS_COMPACT", None)


def sort_lanes(rng, torch, dev, N: int, keys: int, vals: int) -> tuple:
    """int32 [N] lanes on ``dev``: keys with ~20% all-ones sentinels and
    ~30% small values (ties), then uniform value lanes."""
    lanes = []
    for i in range(keys + vals):
        c = rng.integers(-(1 << 31), 1 << 31, size=N, dtype=np.int64)
        if i < keys:
            c[rng.random(N) < 0.2] = -1
            tie = rng.random(N) < 0.3
            c[tie] = rng.integers(-2, 3, size=int(tie.sum()))
        lanes.append(torch.from_numpy(c.astype(np.int32)).to(dev))
    return tuple(lanes)


def sort_matches_plain(cuda_sort, lanes: tuple, keys: int, block: int) -> int:
    """Kernel C on ``lanes`` against its plain version: key lanes equal,
    and each block's rows the same multiset (both results sorted on every
    lane compare equal).  Returns the largest key difference (0)."""
    import torch

    got = cuda_sort.sort_blocks(lanes, keys, block)
    torch.cuda.synchronize()
    ref = cuda_sort.sort_blocks_reference(lanes, keys, block)
    err = 0
    for g, r in zip(got[:keys], ref[:keys]):
        err = max(err, int((g.to(torch.int64) - r.to(torch.int64)).abs().max()))
        check(torch.equal(g, r), f"sort: keys differ, block {block}, {keys} keys, "
                                 f"{lanes[0].numel()} rows")
    whole = len(lanes)
    for g, r in zip(cuda_sort.sort_blocks_reference(got, whole, block),
                    cuda_sort.sort_blocks_reference(ref, whole, block)):
        check(torch.equal(g, r), f"sort: a block's rows changed, block {block}, {keys} keys, "
                                 f"{whole} lanes, {lanes[0].numel()} rows")
    return err


def merge_matches_plain(cbm, count_sort, lanes: tuple, keys: int) -> int:
    """Kernel D on the rows of ``lanes`` arranged as [A ascending | B
    descending] against its plain version: key lanes equal to the plain
    version's and to the sorted keys (``torch.sort`` of the packed keys),
    rows the same multiset.  Returns the largest key difference (0)."""
    import torch

    src = cbm.bitonic_input(lanes, keys)
    got = cbm.bitonic_merge_(src.clone(), keys, 1024)
    new = cbm.bitonic_merge(tuple(src), keys, 1024)  # out of place
    torch.cuda.synchronize()
    for g, w in zip(got, new):
        check(torch.equal(g, w), "merge: in place and out of place differ")
    del new
    ref = cbm.bitonic_merge_reference(tuple(src), keys, 1024)
    want = count_sort.sort_columns(list(lanes[:keys]))[0]
    n = lanes[0].numel()
    err = 0
    for g, r, w in zip(got[:keys], ref[:keys], want):
        err = max(err, int((g.to(torch.int64) - r.to(torch.int64)).abs().max()))
        check(torch.equal(g, r), f"merge: keys differ from plain, {keys} keys, {n} rows")
        check(torch.equal(g, w), f"merge: keys not sorted, {keys} keys, {n} rows")
    for g, r in zip(count_sort.sort_columns(list(got))[0], count_sort.sort_columns(list(ref))[0]):
        check(torch.equal(g, r), f"merge: the rows changed, {keys} keys, {len(lanes)} lanes, "
                                 f"{n} rows")
    return err


def check_mesh_run(summary: dict, n_bases: int, expect: int, out5: str, tag: str) -> None:
    """Phase 5's checks on a mesh run, and bin files equal to those of the
    single device's run on the same reads (``out5``)."""
    from fastkmer_tpu_torch import api

    out = summary["output_dir"]
    check(summary["placement"] == ["cuda:0"] * 4, f"{tag}: placement {summary['placement']}")
    check(api.verify_output(out)["ok"], f"{tag}: manifest verify failed")
    n_lines, total, ascending = read_bin_table(out, 28)
    check(summary["n_bases"] == n_bases, f"{tag}: n_bases mismatch")
    check(summary["n_instances"] == expect,
          f"{tag}: n_instances {summary['n_instances']} != valid windows {expect}")
    check(total == expect, f"{tag}: sum of written counts {total} != {expect}")
    check(n_lines == summary["n_unique"], f"{tag}: written lines != n_unique")
    check(ascending, f"{tag}: a bin file is not strictly ascending")
    check(same_bin_files(out5, out), f"{tag}: bin files differ from the single device's")


MS_MEASURES = ("multisequence.SquaredEuclidean", "multisequence.KLDLog2", "multisequence.KLDLogN")
# phase 17: one rank of a multi-process run, started with the launcher's
# environment; it zeroes its kernels' counts, runs cli.main and reports
RANK_WORKER = r"""
import json, os, sys, time
repo, report, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, repo)
import torch
from fastkmer_tpu_torch import cli
from fastkmer_tpu_torch.ops import cuda_extract, cuda_sort
torch.cuda.reset_peak_memory_stats()
cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = cuda_sort.LAUNCHES = 0
t0 = time.perf_counter()
rc = cli.main(argv)
wall = time.perf_counter() - t0
with open(f"{report}.rank{os.environ['RANK']}", "w") as f:
    json.dump(dict(rc=rc, wall=wall, count=cuda_extract.LAUNCHES, full=cuda_extract.FULL_LAUNCHES,
                   sort=cuda_sort.LAUNCHES, peak=torch.cuda.max_memory_allocated()), f)
"""
RANKS = 2  # phase 17: ranks, each with 2 of the 4 shards, all on card 0
RANK_TIMEOUT_S = 420


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(tmp: str, argv: list, tag: str) -> list:
    """Run ``cli.main(argv)`` in RANKS processes joined through the
    launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    LOCAL_RANK, LOCAL_WORLD_SIZE), as torchrun would.  A rank that fails or
    outlives RANK_TIMEOUT_S fails the phase (every rank is killed then).
    -> per rank: its report (rc, wall, launches, peak memory) and summary,
    and rank 0's ``[multihost]`` lines."""
    script = os.path.join(tmp, "rank_worker.py")
    with open(script, "w") as f:
        f.write(RANK_WORKER)
    report = os.path.join(tmp, f"{tag}.report")
    port = str(free_port())
    procs = []
    for r in range(RANKS):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(RANKS), "LOCAL_RANK": str(r),
               "LOCAL_WORLD_SIZE": str(RANKS), "MASTER_ADDR": "localhost", "MASTER_PORT": port}
        procs.append(subprocess.Popen([sys.executable, script, REPO, report, json.dumps(argv)],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs, deadline = [], time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"17 {tag}: a rank did not finish within {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    stats = argv[argv.index("--stats-json") + 1]
    ranks = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"17 {tag}: rank {r} exited {p.returncode}:\n{out[-3000:]}")
        with open(f"{report}.rank{r}") as f, open(f"{stats}.rank{r}") as g:
            ranks.append({**json.load(f), "summary": json.load(g)})
    for line in outs[0].splitlines():
        if line.startswith("[multihost]"):
            log(f"[multihost 17] {tag}: {line}")
    return ranks


def multihost_phase(tmp: str, fa: str, out7: str, s7: dict, fa4: str, single4: str) -> int:
    """Phase 17: (a) phase 7's run across RANKS processes of 2 shards each
    (global n = 4) on the one card; (b) phase 4's FASTA through
    ``--smer-transport`` with enableKryo and a checkpoint directory per
    rank.  -> kernel B's launches in (a), all ranks."""
    from fastkmer_tpu_torch.output import manifest, writer

    t17 = time.perf_counter()
    stats = os.path.join(tmp, "stats17.json")
    argv = ["28", "10", "3", "2048", "0", "0", fa, tmp + "/", "stream17_", "1", "0", "1", "4",
            "--mesh", "4", "--device", "cuda", "--reads-per-batch", "4096", "--read-len", "4096",
            "--unique-ub", str(GENOME), "--stats-json", stats]
    t0 = time.perf_counter()
    ranks = run_ranks(tmp, argv, "a")
    wall = time.perf_counter() - t0
    sums = [r["summary"] for r in ranks]
    out = sums[0]["output_dir"]
    man = json.load(open(os.path.join(out, "manifest.json")))
    nb = sums[0]["n_batches"]
    full = sum(r["full"] for r in ranks)
    prepass = 4 * -(-nb // 100)  # 1-in-100 sampling of each rank's stripe
    check(all(s["backend"] == "gloo" and s["placement"] == ["cuda:0"] * 2 for s in sums),
          f"17: backend / placement {[(s['backend'], s['placement']) for s in sums]}")
    check(all(r["count"] == 0 and r["sort"] == 0 for r in ranks), "17: a count or sort launch")
    check(all(s["n_batches"] == nb == s7["n_batches"] for s in sums),
          f"17: steps {[s['n_batches'] for s in sums]}, phase 7 {s7['n_batches']}")
    check(full >= 4 * nb + prepass, f"17: {full} kernel B launches for {nb} global batches")
    check(manifest.verify_output(out)["ok"], "17: the merged manifest does not verify")
    check(same_bin_files(out7, out), "17: the union of bin files differs from phase 7's")
    check((man["n_unique"], man["n_instances"]) == (s7["n_unique"], s7["n_instances"])
          == (sum(s["n_unique"] for s in sums), sum(s["n_instances"] for s in sums)),
          f"17: n_unique / n_instances {man['n_unique']} / {man['n_instances']}")
    check(all(s["exchange_bytes"] == s7["exchange_bytes"] for s in sums),
          f"17: exchange_bytes {[s['exchange_bytes'] for s in sums]}, phase 7 "
          f"{s7['exchange_bytes']}")
    log(f"[multihost 17] (a) {RANKS} ranks x 2 shards on one card, backend "
        f"{sums[0]['backend']}, exchange {sums[0]['exchange_staging']}: bin files == phase 7's, "
        f"merged manifest verified, {man['n_unique']} distinct, {man['n_instances']} instances, "
        f"exchange_bytes {sums[0]['exchange_bytes']} (phase 7 {s7['exchange_bytes']}), {nb} "
        f"steps, kernel B launches {[r['full'] for r in ranks]} (sum {full})")
    log(f"[multihost 17] (a) wall {wall:.2f} s from spawn, = "
        f"{s7['n_bases'] / wall / 1e9:.4f} Gbp/s (phase 7: {s7['wall']:.2f} s)")
    for r, (rep, s) in enumerate(zip(ranks, sums)):
        log(f"[multihost 17] (a) rank {r}: cli.main {rep['wall']:.2f} s, peak device memory "
            f"{rep['peak'] / 2**30:.2f} GiB, collectives {json.dumps(s['collectives'])}, "
            f"spans {json.dumps(s['timings'])}")
    shutil.rmtree(out)
    # (b) per batch, super-k-mer transport, enableKryo, a checkpoint dir a rank
    ck = os.path.join(tmp, "ck17")
    argv = ["28", "10", "3", "2048", "0", "0", fa4, tmp + "/", "kryo17_", "1", "1", "1", "4",
            "--mesh", "4", "--smer-transport", "--device", "cuda", "--reads-per-batch", "256",
            "--read-len", "4096", "--checkpoint-dir", ck, "--checkpoint-interval", "1",
            "--stats-json", stats]
    t0 = time.perf_counter()
    ranks = run_ranks(tmp, argv, "b")
    wall_b = time.perf_counter() - t0
    kdir = ranks[0]["summary"]["output_dir"]
    check(manifest.verify_output(kdir)["ok"], "17 b: the merged manifest does not verify")
    check(not [n for n in os.listdir(kdir) if n.startswith("bin")], "17 b: text bins written")
    for r in range(RANKS):
        d = os.path.join(ck, f"rank{r}")
        check(os.path.isdir(d) and not os.listdir(d), f"17 b: {d} is not empty")
    parts = []
    for r in range(RANKS):
        with np.load(os.path.join(kdir, f"counts.part{r}.npz")) as z:
            parts.append((z["words"], z["counts"], z["bins"]))
    words = np.concatenate([p[0] for p in parts])
    order = np.lexsort(tuple(words[:, w] for w in reversed(range(words.shape[1]))))
    union = os.path.join(tmp, "union17")
    writer.write_bin_files(union, words[order], np.concatenate([p[1] for p in parts])[order],
                           np.concatenate([p[2] for p in parts])[order], 28)
    check(same_bin_files(single4, union), "17 b: the union of counts.part*.npz != phase 4's table")
    log(f"[multihost 17] (b) --smer-transport enableKryo: {words.shape[0]} distinct in "
        f"{RANKS} shards == phase 4's table, manifest verified, checkpoint dirs emptied, "
        f"kernel B launches {[r['full'] for r in ranks]}, {wall_b:.2f} s")
    log(f"[multihost 17] phase 17 {time.perf_counter() - t17:.2f} s")
    return full


MS_GENOME = 1 << 21  # phase 15: each of the 8 sequences
MS_SEQS = 8
MS_COVERAGE = 8


@contextlib.contextmanager
def captured_multiseq():
    """Inside the block, the single-device multiseq jobs the CLI calls keep
    their results in the yielded list (the CLI prints only a summary;
    phase 15 holds the run's own table)."""
    from fastkmer_tpu_torch.multiseq import pipeline as ms_pipeline

    got = []
    real = ms_pipeline.execute_multiseq_job

    def run(*a, **kw):
        got.append(real(*a, **kw))
        return got[-1]

    ms_pipeline.execute_multiseq_job = run
    try:
        yield got
    finally:
        ms_pipeline.execute_multiseq_job = real


def multiseq_small(tmp: str) -> dict:
    """Phase 14: multiseq on 4 sequences (a 32768-base genome and three
    copies with 1% substitutions, 1000 150-base reads of each, 0.1% N)
    through ``cli.main --multiseq`` at k = 28, 32 and 55 under the three
    measures, cuda against cpu; ``--mesh 4 useCustomPartitioner=1 4`` cuda
    against cpu and the single device; a run killed after batch 3 and
    resumed; the single-device ``--prededup on`` error.  -> kernel A's and
    B's launches."""
    import torch

    from fastkmer_tpu_torch import cli
    from fastkmer_tpu_torch.multiseq import pipeline as ms_pipeline
    from fastkmer_tpu_torch.ops import cuda_extract

    t14 = time.perf_counter()
    rng = np.random.default_rng(14)
    genomes = mutated_copies(rng, rng.integers(0, 4, size=1 << 15, dtype=np.uint8), 4, 0.01)
    fa = os.path.join(tmp, "ms14.fa")
    write_tagged_fasta(fa, [sample_reads(rng, g, 1000, 0.001) for g in genomes])
    stats = os.path.join(tmp, "stats.json")

    def argv(k, m, measure, d, prefix="ms14_", part=("0",), extra=()):
        return [str(k), str(m), "3", "2048", "0", "0", fa, tmp + "/", prefix, "1", "0", *part,
                "--device", d, "--reads-per-batch", "32", "--read-len", "4096",
                "--multiseq", "--distance-measure", measure, "--stats-json", stats, *extra]

    launches = {"A": 0, "B": 0}
    single = {}
    for k, m, measure in ((28, 10, MS_MEASURES[0]), (32, 9, MS_MEASURES[1]),
                          (55, 9, MS_MEASURES[2])):
        out = {}
        for d in ("cuda", "cpu"):
            cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = 0
            check(cli.main(argv(k, m, measure, d)) == 0, f"14: k={k} {d}: cli.main failed")
            summary = json.load(open(stats))
            if d == "cuda":
                check(cuda_extract.LAUNCHES >= summary["n_batches"] > 4
                      and cuda_extract.FULL_LAUNCHES == 0,
                      f"14: k={k}: {cuda_extract.LAUNCHES} kernel A launches, "
                      f"{cuda_extract.FULL_LAUNCHES} of B for {summary['n_batches']} batches")
                launches["A"] += cuda_extract.LAUNCHES
            out[d] = dir_bytes(summary["output_dir"])
        check(out["cuda"] == out["cpu"], f"14: k={k}: cuda and cpu directories differ")
        check("distances.json" in out["cuda"] and summary["sequences"] == ["S0", "S1", "S2", "S3"]
              and summary["n_distance_pairs"] == (6 if k == 28 else 12),
              f"14: k={k}: {summary['sequences']}, {summary['n_distance_pairs']} pairs")
        single[k] = (summary["output_dir"], out["cuda"])
        log(f"[multiseq 14] k={k} {measure}: {summary['n_unique_kmer_seq']} (k-mer, seq) pairs, "
            f"{summary['n_batches']} batches, {len(out['cuda'])} files cuda == cpu")
    mesh = {}
    for d in ("cuda", "cpu"):
        cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = 0
        check(cli.main(argv(28, 10, MS_MEASURES[0], d, "ms14mesh_", ("1", "4"),
                            ("--mesh", "4"))) == 0, f"14: mesh {d}: cli.main failed")
        summary = json.load(open(stats))
        if d == "cuda":
            check(cuda_extract.FULL_LAUNCHES >= 4 * summary["n_batches"]
                  and cuda_extract.LAUNCHES == 0,
                  f"14: mesh: {cuda_extract.FULL_LAUNCHES} kernel B launches, "
                  f"{cuda_extract.LAUNCHES} of A for {summary['n_batches']} batches")
            launches["B"] = cuda_extract.FULL_LAUNCHES
        mesh[d] = dir_bytes(summary["output_dir"])
    check(mesh["cuda"] == mesh["cpu"], "14: mesh cuda and cpu directories differ")
    check({n: b for n, b in mesh["cuda"].items() if n != "manifest.json"}
          == {n: b for n, b in single[28][1].items() if n != "manifest.json"},
          "14: the mesh's bins or distances.json differ from the single device's")
    log(f"[multiseq 14] --mesh 4: cuda == cpu, bins and distances.json == the single "
        f"device's; exchange_bytes {summary['exchange_bytes']}, {launches['B']} kernel B launches")
    out28, want = single[28]
    with open(os.path.join(out28, "manifest.json")) as f:
        cfg = ms_pipeline.MultiseqConfig(**json.load(f)["config"])
    ck = os.path.join(tmp, "ck14")
    _, t_resume, t_die = interrupt_and_resume(
        lambda: ms_pipeline.execute_multiseq_job(cfg, verbose=False, device="cuda",
                                                 device_accumulate=True, checkpoint_dir=ck,
                                                 checkpoint_interval=2),
        ck, 0, 2, "14 resume", at=3, reader_name="batch_codes_dense_tagged")
    check(dir_bytes(out28) == want, "14: the resumed directory differs")
    log(f"[multiseq 14] killed after batch 3, resumed from batch 2: directory == the "
        f"uninterrupted one ({t_die:.2f} s + {t_resume:.2f} s)")
    try:
        cli.main(argv(28, 10, MS_MEASURES[0], "cuda", extra=("--prededup", "on")))
    except NotImplementedError as e:
        log(f"[multiseq 14] --prededup on without a mesh raises: {e}")
    else:
        raise RuntimeError("14: --prededup on without a mesh did not raise")
    torch.cuda.synchronize()
    log(f"[multiseq 14] phase 14 {time.perf_counter() - t14:.2f} s")
    return launches


def multiseq_real(tmp: str) -> dict:
    """Phases 15 and 16: multiseq at real size, 8 sequences (a 2^21-base
    genome and seven copies with 1% substitutions), 150-base reads from
    both strands at 8x coverage of each, 0.1% N, grouped by sequence:
    134,217,728 bases.  15: the single device against the count job on the
    same FASTA and the device Gram against the host under the three
    measures; 16: the streaming mesh against phase 15.  -> kernel A's
    launches in 15 and B's in 16."""
    import torch

    from fastkmer_tpu_torch import api, cli
    from fastkmer_tpu_torch.multiseq import distances as ms_distances
    from fastkmer_tpu_torch.multiseq import pipeline as ms_pipeline
    from fastkmer_tpu_torch.ops import cuda_extract

    t0 = time.perf_counter()
    rng = np.random.default_rng(15)
    genomes = mutated_copies(rng, rng.integers(0, 4, size=MS_GENOME, dtype=np.uint8),
                             MS_SEQS, 0.01)
    reads = [sample_reads(rng, g, MS_COVERAGE * MS_GENOME // READ_LEN, 0.001) for g in genomes]
    fa = os.path.join(tmp, "ms15.fa")
    write_tagged_fasta(fa, reads)
    expect = sum(valid_windows(r, 28) for r in reads)
    n_bases = sum(r.size for r in reads)
    del genomes, reads
    log(f"[multiseq 15] {n_bases} bases in {MS_SEQS} sequences, {expect} valid windows; "
        f"data made in {time.perf_counter() - t0:.1f} s")
    stats = os.path.join(tmp, "stats.json")
    base = ["28", "10", "3", "2048", "0", "0", fa, tmp + "/"]
    opts = ["--device", "cuda", "--reads-per-batch", "4096", "--read-len", "4096",
            "--unique-ub", str(MS_SEQS * MS_GENOME), "--stats-json", stats]

    # --- 15. the single device ---------------------------------------------
    t15 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = 0
    t0 = time.perf_counter()
    with captured_multiseq() as got:
        rc = cli.main(base + ["ms15_", "1", "0", "0", "--multiseq"] + opts)
    wall = time.perf_counter() - t0
    launches_a = cuda_extract.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"15: cli.main returned {rc}")
    s15 = json.load(open(stats))
    res = got[0]
    out15 = s15["output_dir"]
    nb = s15["n_batches"]
    check(cuda_extract.FULL_LAUNCHES == 0, "15: the single device launched kernel B")
    check(nb >= -(-n_bases // (4096 * 4096)) and launches_a >= nb,
          f"15: {launches_a} kernel A launches for {nb} batches")
    check(api.verify_output(out15)["ok"], "15: manifest verify failed")
    check(s15["n_instances"] == expect, f"15: n_instances {s15['n_instances']} != valid "
                                        f"windows {expect}")
    check(s15["sequences"] == [f"S{i}" for i in range(MS_SEQS)], f"15: {s15['sequences']}")
    n_lines, total, ascending = read_bin_table(out15, 28)
    check(total == expect and ascending, f"15: written counts {total}, ascending {ascending}")
    count_s = wall - s15["timings"]["write_output"]
    log(f"[multiseq 15] {s15['n_unique_kmer_seq']} (k-mer, seq) pairs, {n_lines} distinct "
        f"k-mers, {nb} batches, {launches_a} kernel A launches")
    log(f"[multiseq 15] end to end {wall:.2f} s = {n_bases / wall / 1e9:.4f} Gbp/s; without "
        f"write_output {n_bases / count_s / 1e9:.4f} Gbp/s")
    log(f"[multiseq 15] stage timings: {json.dumps(s15['timings'])}")
    log(f"[multiseq 15] peak device memory {peak / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    check(cli.main(base + ["cnt15_", "1", "0", "0"] + opts) == 0, "15: the count job failed")
    t_count = time.perf_counter() - t0
    sc = json.load(open(stats))
    check(same_bin_files(out15, sc["output_dir"]), "15: bin files differ from the count job's")
    shutil.rmtree(sc["output_dir"])
    log(f"[multiseq 15] the count job on the same FASTA: {t_count:.2f} s "
        f"(spans {json.dumps(sc['timings'])}); bin files identical")
    S = len(res.sequence_names)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the Gram must not take it
    try:
        for name in MS_MEASURES:
            measure = ms_distances.get_measure(name)
            t0 = time.perf_counter()
            host = ms_pipeline.accumulate_distances(res.words, res.seqs, res.counts, S, measure)
            t_host = time.perf_counter() - t0
            t0 = time.perf_counter()
            dev = ms_pipeline.accumulate_distances(res.words, res.seqs, res.counts, S, measure,
                                                   device=True)
            t_dev = time.perf_counter() - t0
            off = ~np.eye(S, dtype=bool)
            rel = float((np.abs(dev - host)[off] / np.abs(host)[off]).max())
            check(rel <= 1e-4, f"15: {name}: device Gram {rel:.3e} relative from the host")
            check(torch.backends.cuda.matmul.allow_tf32, "15: the TF32 setting was not restored")
            log(f"[multiseq 15] {name}: device Gram within {rel:.3e} relative of the host "
                f"(host {t_host:.3f} s, device {t_dev:.3f} s, {res.words.shape[0]} rows)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[multiseq 15] phase 15 {time.perf_counter() - t15:.2f} s")

    # --- 16. the streaming mesh --------------------------------------------
    t16 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(base + ["ms16_", "1", "0", "1", "4", "--multiseq", "--mesh", "4"] + opts)
    wall16 = time.perf_counter() - t0
    launches_b = cuda_extract.FULL_LAUNCHES
    peak16 = torch.cuda.max_memory_allocated()
    check(rc == 0, f"16: cli.main returned {rc}")
    s16 = json.load(open(stats))
    out16 = s16["output_dir"]
    check(cuda_extract.LAUNCHES == 0, "16: the mesh launched kernel A")
    check(s16["n_batches"] == nb and launches_b >= 4 * nb,
          f"16: {launches_b} kernel B launches for {s16['n_batches']} batches on 4 shards")
    check(s16["placement"] == ["cuda:0"] * 4, f"16: placement {s16['placement']}")
    check(api.verify_output(out16)["ok"], "16: manifest verify failed")
    check(same_bin_files(out15, out16), "16: bin files differ from phase 15's")
    check(open(os.path.join(out15, "distances.json"), "rb").read()
          == open(os.path.join(out16, "distances.json"), "rb").read(),
          "16: distances.json differs from phase 15's")
    count16 = wall16 - s16["timings"]["write_output"]
    log(f"[multiseq 16] --mesh 4: {s16['n_unique_kmer_seq']} pairs, {launches_b} kernel B "
        f"launches; bin files and distances.json == phase 15's")
    log(f"[multiseq 16] end to end {wall16:.2f} s = {n_bases / wall16 / 1e9:.4f} Gbp/s; "
        f"without write_output {n_bases / count16 / 1e9:.4f} Gbp/s (4 shards on one card)")
    log(f"[multiseq 16] stage timings: {json.dumps(s16['timings'])}")
    log(f"[multiseq 16] exchange_bytes {s16['exchange_bytes']}, balance "
        f"{json.dumps(s16['balance'])}")
    log(f"[multiseq 16] peak device memory {peak16 / 2**30:.2f} GiB; phase 16 "
        f"{time.perf_counter() - t16:.2f} s")
    return {"A": launches_a, "B": launches_b}


def bench_entry_phase(cuda_extract) -> dict:
    """Phase 18: the bench at bench.py's full shapes in its default mode
    (the line logged, the sanity checks held, kernel A once a batch in
    the warm-up and the timed pass and once a count of the step line);
    every other mode at 4 batches of the dup workload, each table equal to
    the default mode's on those batches; ``entry()`` on the card
    equal to ``entry("cpu")`` on the same codes and ``dryrun_multichip(4)``
    equal to the CPU run's five numbers, each with kernel B launched.
    -> the phase's launches of A and B."""
    import torch

    from fastkmer_tpu_torch import bench, entry

    t18 = time.perf_counter()
    cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = 0
    rec, _ = bench.run()
    a_default = cuda_extract.LAUNCHES
    log(f"[bench 18] bench: {json.dumps(rec)}")
    check(rec["metric"] == "stream_count_throughput_k28_m10" and rec["unit"] == "Gbp/s"
          and rec["value"] > 0 and rec["extra"]["step_gbps"] > 0, f"18: bench line {rec}")
    # one A a batch in the warm-up pass and in the timed pass (batch 0's
    # dedup probe extracts once too), and one a count of the step line
    want_a = 2 * bench.NBATCH + bench.STEP_WARMUPS + bench.STEP_ITERS
    check(a_default == want_a, f"18: {a_default} kernel A launches in the default bench run, "
          f"{want_a} expected: one a batch in each of its two passes and one a step")
    _, ref = bench.run("stream", dup=True, n_batch=4)
    for mode in bench.MODES[1:]:
        mrec, table = bench.run(mode, dup=True, n_batch=4)
        if table is not None:
            check(all(np.array_equal(a, b) for a, b in zip(table, ref)),
                  f"18: {mode}'s table differs from stream's on the same 4 batches")
        log(f"[bench 18] bench {mode} (dup, 4 batches): {mrec['value']:.4f} Gbp/s"
            f"{'' if table is None else ', table == stream'}")
    a18 = cuda_extract.LAUNCHES
    cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = 0
    step, (codes,) = entry.entry()
    got = step(codes)
    cpu_step, _ = entry.entry("cpu")
    want = cpu_step(codes.cpu())
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "18: entry() on the card != entry('cpu') on the same codes")
    b_entry = cuda_extract.FULL_LAUNCHES
    check(b_entry > 0, "18: entry() launched no kernel B")
    cuda_extract.FULL_LAUNCHES = 0
    dry = entry.dryrun_multichip(4)
    b_dry = cuda_extract.FULL_LAUNCHES
    dry_cpu = entry.dryrun_multichip(4, "cpu")
    check(dry == dry_cpu, f"18: dryrun_multichip(4) {dry} != the CPU run's {dry_cpu}")
    check(b_dry > 0, "18: dryrun_multichip(4) launched no kernel B")
    log(f"[bench 18] entry() == entry('cpu'), {b_entry} kernel B launch(es); "
        f"dryrun_multichip(4) == the CPU run's {dry}, {b_dry} kernel B launches; kernel A "
        f"{a_default} launches in the default bench run, {a18} in the phase; phase 18 "
        f"{time.perf_counter() - t18:.2f} s")
    return {"A": a18, "B": b_entry + b_dry}


def read_set_table(rng, n: int) -> tuple:
    """A read set's table at k = 55 shaped like the benchmark cell's: n
    sorted 110-bit keys as [n, 4] uint32, 78% of the counts 1 and the rest
    about 64x coverage's, bins under 2048."""
    keys = rng.integers(0, 1 << 32, size=(n, 4), dtype=np.uint64).astype(np.uint32)
    keys[:, 3] &= np.uint32(0xFFFFC000)
    counts = np.where(rng.random(n) < 0.78, 1, rng.poisson(29, n).clip(2, None))
    return (keys[np.lexsort(keys.T[::-1])], counts.astype(np.int64),
            rng.integers(0, 2048, n).astype(np.int32))


def user_s() -> float:
    """This process's user CPU seconds, every thread's."""
    return os.times().user


def deflate_phase(rng, tmp: str, fa5: str, summary5: dict) -> dict:
    """Phase 19: the card's deflate of counts.npz (``output.cuda_deflate``).
    (a) The kernel's stream, CRC, segments and stored segments equal the
    plain version's on each member of a 12,000-row read-set table, on
    random bytes (stored) and on zeros, in one piece and a piece a segment.
    (b) ``write_binary`` on the card: the host path's members, every CRC
    holding, the same file twice, ``write_card_segments`` > 0.  (c) At the
    benchmark cell's table shape (4,770,000 rows, 134 MB of members, two
    pieces): the kernels' device time by CUDA events over the staged pieces
    beside the bound (bytes in + out at 3.35 TB/s); each member's first
    three segments equal to the plain version's (whose ms a segment is
    timed on them), its CRC zlib's; the card path's write (median of 5,
    host clock, its spans ``npz_encode`` and ``npz_file``, user CPU); its
    members the arrays; the host path's write and ``np.savez_compressed``,
    and the file's size against theirs (at most 3% over numpy's).  (d) The
    main path: phase 5's reads (``fa5``) through ``cli.main`` with
    enableKryo=1 on the card, the launches counted from 0 just before it:
    one a piece of the job's ``write_card_segments``, the manifest
    verified, and the npz read back holds phase 5's table (``summary5``'s
    distinct k-mers and instances).  -> the kernel's numbers for the
    summary."""
    import statistics
    import zipfile
    import zlib

    import torch

    from fastkmer_tpu_torch import api, cli
    from fastkmer_tpu_torch.benchmarks._common import HBM_BYTES_PER_S, time_ms
    from fastkmer_tpu_torch.output import cuda_deflate, npz, writer
    from fastkmer_tpu_torch.utils.timing import StageTimer

    t19 = time.perf_counter()
    dev = torch.device("cuda", 0)
    cuda_deflate.LAUNCHES = 0
    differ = 0  # streams or CRCs of the kernel that differ from the plain version's
    words, counts, bins = read_set_table(rng, 12_000)
    cases = {"words": words, "counts": counts, "bins": bins, "k": np.int32(55),
             "random": rng.integers(0, 256, 70_000, dtype=np.uint8),
             "zeros": np.zeros(140_000, np.uint8)}
    piece = cuda_deflate.PIECE
    for name, arr in cases.items():
        head, data = npz._member(arr)
        want = cuda_deflate.deflate_plain(bytes(head) + bytes(data))
        for cuda_deflate.PIECE in (piece, 1):
            (pieces, *rest), = cuda_deflate.deflate([(head, data)], dev)
            same = (b"".join(p.tobytes() for p in pieces) == want[0]
                    and tuple(rest) == want[1:])
            differ += not same
            check(same, f"19 a: the kernel's {name} differs from the plain version's "
                        f"(piece {cuda_deflate.PIECE}: {tuple(rest)} against {want[1:]})")
        cuda_deflate.PIECE = piece
    log(f"[deflate 19] (a) kernel == plain on {', '.join(cases)}, one piece and a piece "
        f"a segment; {cuda_deflate.LAUNCHES} launches")
    t = StageTimer()
    card = writer.write_binary(os.path.join(tmp, "card"), words, counts, bins, 55, timer=t,
                               device=dev)
    again = writer.write_binary(os.path.join(tmp, "again"), words, counts, bins, 55,
                                device=dev)
    host = writer.write_binary(os.path.join(tmp, "host"), words, counts, bins, 55)
    got = []
    for path in (card, host):
        with zipfile.ZipFile(path) as z:
            check(z.testzip() is None, f"19 b: a CRC of {path} fails")
            got.append({n: z.read(n) for n in z.namelist()})
    check(got[0] == got[1], "19 b: the card's members differ from the host path's")
    check(open(card, "rb").read() == open(again, "rb").read(), "19 b: two writes differ")
    check(t.counters()["write_card_segments"] > 0, "19 b: no segment deflated on the card")
    log(f"[deflate 19] (b) card members == host members, two writes identical, counters "
        f"{json.dumps(t.counters())}")

    # (c) the cell's table shape
    words, counts, bins = read_set_table(rng, DEFLATE_ROWS)
    arrays = {"words": words, "counts": counts, "bins": bins, "k": np.int32(55)}
    members = [npz._member(a) for a in arrays.values()]
    nbytes = sum(len(h) + len(d) for h, d in members)
    d = cuda_deflate.Deflater(members, dev)
    check(len(d.pieces) <= 2, f"19 c: {len(d.pieces)} pieces do not fit two slots")
    for k in range(len(d.pieces)):
        d.stage(k)
    kernel_ms = time_ms(lambda: [d.run(k) for k in range(len(d.pieces))], 5,
                        setup=d.state.zero_)
    streams = [[] for _ in members]
    for k in range(len(d.pieces)):
        for m, part in d.collect(k):
            streams[m].append(part.tobytes())
    streams = [b"".join(x) for x in streams]
    crcs = [crc for crc, _, _ in d.totals()]
    plain_s, plain_segs = 0.0, 0
    for (head, data), stream, crc in zip(members, streams, crcs):
        differ += crc != zlib.crc32(data, zlib.crc32(head))
        if len(data) < 3 * cuda_deflate.SEG:
            continue
        raw = bytes(head) + bytes(data[:3 * cuda_deflate.SEG])
        t0 = time.perf_counter()
        want = cuda_deflate.deflate_plain(raw, segments=3)[0]
        plain_s += time.perf_counter() - t0
        plain_segs += 3
        differ += stream[:len(want)] != want
    check(differ == 0 and plain_segs == 9,
          f"19 c: {differ} streams or CRCs differ from the plain version's or zlib's")
    path = os.path.join(tmp, "counts.npz")
    npz.write_npz(path, arrays, device=dev)  # warm
    walls, spans, users = [], [], []
    for _ in range(5):
        t = StageTimer()
        torch.cuda.synchronize()
        t0, u0 = time.perf_counter(), user_s()
        npz.write_npz(path, arrays, timer=t, device=dev)
        walls.append(time.perf_counter() - t0)
        users.append(user_s() - u0)
        spans.append(t.as_dict())
    counters = t.counters()
    card_size = os.path.getsize(path)
    with np.load(path, allow_pickle=False) as z:
        check(all(np.array_equal(z[n], a) for n, a in arrays.items()),
              "19 c: the card's npz members are not the arrays")
    bound_ms = (nbytes + card_size) / HBM_BYTES_PER_S * 1e3
    segs = counters["write_card_segments"]
    host_walls, host_users = [], []
    for _ in range(2):
        t0, u0 = time.perf_counter(), user_s()
        npz.write_npz(os.path.join(tmp, "host.npz"), arrays)
        host_walls.append(time.perf_counter() - t0)
        host_users.append(user_s() - u0)
    t0 = time.perf_counter()
    np.savez_compressed(os.path.join(tmp, "numpy.npz"), **arrays)
    numpy_s = time.perf_counter() - t0
    host_size = os.path.getsize(os.path.join(tmp, "host.npz"))
    numpy_size = os.path.getsize(os.path.join(tmp, "numpy.npz"))
    check(card_size <= 1.03 * numpy_size,
          f"19 c: the card's npz {card_size} B is over 3% above numpy's {numpy_size} B")
    log(f"[deflate 19] (c) {nbytes} member bytes, {segs} segments in {len(d.pieces)} pieces "
        f"({counters['write_stored_segments']} stored): kernels {kernel_ms:.3f} ms (CUDA "
        f"events, median of 5) against a {bound_ms:.4f} ms bound; first 3 segments of each "
        f"array == plain, CRCs == zlib's; card write {statistics.median(walls) * 1e3:.1f} ms "
        f"(runs {', '.join(f'{w * 1e3:.1f}' for w in walls)}; npz_encode "
        f"{statistics.median(s['npz_encode'] for s in spans) * 1e3:.1f}, npz_file "
        f"{statistics.median(s['npz_file'] for s in spans) * 1e3:.1f}; user CPU "
        f"{statistics.median(users):.2f} s); plain {plain_s / plain_segs * 1e3:.1f} ms a "
        f"segment ({plain_s * 1e3:.1f} ms for {plain_segs}); host path "
        f"{', '.join(f'{w * 1e3:.1f}' for w in host_walls)} ms (user CPU "
        f"{', '.join(f'{u:.2f}' for u in host_users)} s); np.savez_compressed "
        f"{numpy_s:.2f} s; sizes card {card_size}, host {host_size}, numpy {numpy_size} "
        f"({card_size / numpy_size - 1:+.4%})")
    del d, arrays, members, words, counts, bins

    # (d) the main path: an enableKryo job on the card over phase 5's reads
    stats = os.path.join(tmp, "kryo.json")
    argv = ["28", "10", "3", "2048", "0", "0", fa5, tmp + "/", "kryo_", "1", "1", "0",
            "--device", "cuda", "--reads-per-batch", "4096", "--read-len", "4096",
            "--unique-ub", str(GENOME), "--stats-json", stats]
    launches = cuda_deflate.LAUNCHES
    cuda_deflate.LAUNCHES = 0
    check(cli.main(argv) == 0, "19 d: the enableKryo job failed")
    job_launches = cuda_deflate.LAUNCHES
    cuda_deflate.LAUNCHES += launches
    summary = json.load(open(stats))
    jc = summary["counters"]
    out = summary["output_dir"]
    check(jc["write_card_segments"] > 0
          and job_launches == -(-jc["write_card_segments"] // cuda_deflate.PIECE),
          f"19 d: {job_launches} launches for {jc['write_card_segments']} card segments")
    check(api.verify_output(out)["ok"], "19 d: the manifest does not verify")
    with zipfile.ZipFile(os.path.join(out, "counts.npz")) as z:
        check(z.testzip() is None, "19 d: a CRC of the job's npz fails")
    res = api.load_binary(os.path.join(out, "counts.npz"))
    n_rows, total = len(res.counts), int(np.asarray(res.counts).sum())
    check((n_rows, total) == (summary5["n_unique"], summary5["n_instances"]),
          f"19 d: the npz holds {n_rows} k-mers, {total} instances; phase 5 "
          f"{summary5['n_unique']}, {summary5['n_instances']}")
    log(f"[deflate 19] (d) enableKryo job on phase 5's reads: {job_launches} launches, "
        f"write_card_segments {jc['write_card_segments']}, write_stored_segments "
        f"{jc['write_stored_segments']}, write_data {summary['timings']['write_data']:.3f} s "
        f"(npz_encode {summary['timings']['npz_encode']:.3f}, npz_file "
        f"{summary['timings']['npz_file']:.3f}); {n_rows} k-mers, {total} instances == phase "
        f"5's; phase 19 {time.perf_counter() - t19:.2f} s")
    return {"launches": cuda_deflate.LAUNCHES, "err": differ, "ms": kernel_ms,
            "plain_ms": plain_s * 1e3, "bound_ms": bound_ms,
            "extra": {"plain_segments": plain_segs, "segments": segs}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from fastkmer_tpu_torch import api, cli
        from fastkmer_tpu_torch.benchmarks import cuda_bitonic_merge, cuda_probe
        from fastkmer_tpu_torch.benchmarks import distance_probe, multiseq_probe
        from fastkmer_tpu_torch.benchmarks import resume_merge_probe, split_merge_probe
        from fastkmer_tpu_torch.benchmarks import e2e, merge_probe, mesh_dedup_probe
        from fastkmer_tpu_torch.benchmarks import skew, stream_probe
        from fastkmer_tpu_torch.benchmarks import bigk_probe, pallas_sort_probe, scaling
        from fastkmer_tpu_torch.benchmarks import smer_pallas_probe
        from fastkmer_tpu_torch.benchmarks._common import HBM_BYTES_PER_S, rand_i32, time_ms
        from fastkmer_tpu_torch.core.tbits import pair_key
        from fastkmer_tpu_torch.ops import count_sort, cuda_extract, cuda_sort, extract
        from fastkmer_tpu_torch import pipeline
        from fastkmer_tpu_torch.config import JobConfig
        from fastkmer_tpu_torch.output import cuda_deflate, manifest
        from fastkmer_tpu_torch.utils.timing import TRACE_FILE
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script ({e})", file=sys.stderr)
        return 1

    t_run = time.perf_counter()
    # --- 1. card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    # phase 4's FASTA and its k = 28 and 32 outputs, kept for phases 11-13
    keep_dir = tempfile.TemporaryDirectory()
    keep = keep_dir.name

    # --- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    libraries = (cuda_extract.library, cuda_sort.library, cuda_bitonic_merge.library,
                 cuda_probe.library, cuda_deflate.library)
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, started together
        list(pool.map(lambda build: build(), libraries))
    log(f"[build] extract, block sort, bitonic merge, pass probe and deflate kernels built "
        f"and loaded in {time.perf_counter() - t0:.2f} s")
    from fastkmer_tpu_torch.utils import cudabuild

    for lib, srcs in (("fkextract", ("extract.cu",)), ("fkblocksort", ("block_sort.cu",)),
                      ("fkbitonicmerge", ("bitonic_merge.cu",)),
                      ("fkpassprobe", ("pass_probe.cu",)), ("fkdeflate", ("deflate.cu",))):
        for fn, (regs, spill, stack) in sorted(
                ptxas_kernels(cudabuild.ptxas_report(lib, srcs)).items()):
            log(f"[build] ptxas {fn}: {regs} registers, {spill} spill bytes, "
                f"{stack} bytes stack frame")
            check(spill == 0 or not re.search("extract_count|extract_full|cluster_sort|"
                                              "merge_partition|merge_tile|copy_pass|"
                                              "transpose_pass", fn),
                  f"{fn} spills {spill} bytes")

    # --- 3. kernel vs plain on the card ------------------------------------
    max_err = 0
    for k, m, flag in EXTRACT_CASES:
        for R, L in ((512, 4096), (3, k + 5)):
            codes = torch.from_numpy(random_codes(rng, R, L)).to(dev)
            got = cuda_extract.extract_sentinel(codes, k, m, 2048, flag_lane=flag)
            torch.cuda.synchronize()
            ref = cuda_extract.extract_sentinel_reference(codes, k, m, 2048, flag_lane=flag)
            torch.cuda.synchronize()
            check(len(got) == len(ref), f"k={k}: {len(got)} columns, plain has {len(ref)}")
            for g, r in zip(got, ref):
                err = int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
                max_err = max(max_err, err)
                check(torch.equal(g, r), f"kernel != plain at k={k} m={m} [{R}, {L}]")
        log(f"[kernel] k={k} m={m} flag={flag}: equal to plain at [512, 4096] and [3, {k + 5}]")
    rng3a = np.random.default_rng(31)  # its own stream: phases 4-6 keep their data
    st = cuda_extract._MAX_K_STAGED
    for k, R, L in ((28, 5, 2048 + 27), (28, 5, 4096 + 28), (97, 5, 3 * 1024 + 96),
                    (55, 5, 1024 + 54), (4, 64, 1024), (256, 8, 256), (32, 5, 2048 + 32),
                    (64, 5, 1024 + 63), (3001, 5, 3001 + 2100), (st, 3, st + 1500),
                    (cuda_extract._MAX_K, 3, cuda_extract._MAX_K + 300)):
        codes = torch.from_numpy(count_edge_codes(rng3a, k, R, L)).to(dev)
        flag = k % 16 == 0
        got = cuda_extract.extract_sentinel(codes, k, 4, 2048, flag_lane=flag)
        torch.cuda.synchronize()
        ref = cuda_extract.extract_sentinel_reference(codes, k, 4, 2048, flag_lane=flag)
        check(len(got) == len(ref), f"edge k={k}: {len(got)} columns, plain has {len(ref)}")
        for g, r in zip(got, ref):
            max_err = max(max_err, int((g.to(torch.int64) - r.to(torch.int64)).abs().max()))
            check(torch.equal(g, r), f"kernel != plain at edge k={k} [{R}, {L}]")
        log(f"[kernel] edge k={k} [{R}, {L}] ({cuda_extract.count_route(k)} route): equal")
    big = torch.from_numpy(random_codes(rng, 4096, 4096)).to(dev)  # phase 5's batch shape
    count_times = {}
    for k, flag in COUNT_TIMED:
        for g, r in zip(cuda_extract.extract_sentinel(big, k, 10, 2048, flag_lane=flag),
                        cuda_extract.extract_sentinel_reference(big, k, 10, 2048, flag_lane=flag)):
            check(torch.equal(g, r), f"kernel != plain at k={k} [4096, 4096]")
        ms = time_ms(lambda: cuda_extract.extract_sentinel(big, k, 10, 2048, flag_lane=flag), 50)
        pms = time_ms(lambda: cuda_extract.extract_sentinel_reference(big, k, 10, 2048,
                                                                       flag_lane=flag), 5)
        # 1 B in, 4·(W + flag) B out per position
        nbytes = 4096 * 4096 + 4 * (-(-k // 16) + flag) * 4096 * (4096 - k + 1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        count_times[k] = (ms, pms, bound)
        log(f"[kernel] [4096, 4096] k={k}{' flag' if flag else ''}: kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s), plain {pms:.4f} ms, bound {bound:.4f} ms "
            f"({bound / ms:.1%})")
    del big
    kernel_ms, plain_ms, count_bound_ms = count_times[28]

    # --- 3b. full-mode kernel vs plain on the card ---------------------------
    rng3b = np.random.default_rng(3)  # its own stream: phases 4-6 keep their data
    full_err = 0
    for k, m, _ in EXTRACT_CASES:
        for R, L in ((512, 4096), (3, k + 5)):
            codes = torch.from_numpy(random_codes(rng3b, R, L)).to(dev)
            got = cuda_extract.extract_full(codes, k, m, 2048)
            torch.cuda.synchronize()
            ref = extract.extract(codes, k, m, 2048)
            torch.cuda.synchronize()
            check(torch.equal(got.valid, ref.valid), f"full: valid differs at k={k} [{R}, {L}]")
            v = ref.valid
            for name, g, r in (("words", got.words, ref.words), ("sigs", got.sigs, ref.sigs),
                               ("bins", got.bins, ref.bins)):
                if v.any():
                    err = int((g[v].to(torch.int64) - r[v].to(torch.int64)).abs().max())
                    full_err = max(full_err, err)
                check(torch.equal(g[v], r[v]), f"full: {name} differ at k={k} m={m} [{R}, {L}]")
            check(bool(((got.bins >= 0) & (got.bins < 2048)).all()),
                  f"full: a bin outside [0, 2048) at k={k} [{R}, {L}]")
        log(f"[full] k={k} m={m}: equal to plain where valid at [512, 4096] and [3, {k + 5}]")
    for k, m, R, L in ((11, 10, 64, 1024), (256, 15, 8, 256), (28, 10, 5, 1024 + 27),
                       (28, 10, 5, 2048 + 28), (97, 13, 3, 3 * 1024 + 96)):
        codes = random_codes(rng3b, R, L)
        codes[1, 1023:1025] = 4  # Ns on the kernel's block boundary
        codes = torch.from_numpy(codes).to(dev)
        got = cuda_extract.extract_full(codes, k, m, 2048)
        ref = extract.extract(codes, k, m, 2048)
        v = ref.valid
        check(got.valid.dtype == torch.bool and torch.equal(got.valid, ref.valid),
              f"full: valid differs at edge k={k} [{R}, {L}]")
        for g, r in ((got.words, ref.words), (got.sigs, ref.sigs), (got.bins, ref.bins)):
            check(torch.equal(g[v], r[v]), f"full: kernel != plain at edge k={k} [{R}, {L}]")
        check(bool(((got.bins >= 0) & (got.bins < 2048)).all()), f"full: bin range, edge k={k}")
    log("[full] edge shapes (k = m + 1, k = 256 with L = k, P = 1024, 2049, 3072): equal")
    big = torch.from_numpy(random_codes(rng3b, 4096, 4096)).to(dev)
    full_times = {}
    for k, m in ((28, 10), (31, 8), (55, 9), (97, 13), (155, 14)):
        got = cuda_extract.extract_full(big, k, m, 2048)
        ref = extract.extract(big, k, m, 2048)
        check(torch.equal(got.valid, ref.valid) and torch.equal(got.bins, ref.bins),
              f"full: kernel != plain at k={k} [4096, 4096]")
        del got, ref
        full_times[k] = (time_ms(lambda: cuda_extract.extract_full(big, k, m, 2048), 20),
                         time_ms(lambda: extract.extract(big, k, m, 2048), 5))
        log(f"[full] [4096, 4096] k={k}: kernel {full_times[k][0]:.4f} ms, "
            f"plain {full_times[k][1]:.4f} ms")
    full_ms, full_plain_ms = full_times[28]
    del big

    # --- 3c. block sort kernel vs plain on the card ----------------------------
    rng3c = np.random.default_rng(33)
    sort_err = 0
    for block in (1024, 8192, SORT_BLOCK):
        for keys in (1, 2, 3, 4):
            for vals in (0, 1):
                lanes = sort_lanes(rng3c, torch, dev, 4 * block, keys, vals)
                sort_err = max(sort_err, sort_matches_plain(cuda_sort, lanes, keys, block))
        log(f"[sort] block {block}: kernel == plain for 1-4 keys, with and without a value")
    for case, keys in (("all-equal keys", 2), ("mostly sentinel", 2), ("13 keys + 1 value", 13),
                       ("15 keys + 1 value, tiled", 15)):
        lanes = sort_lanes(rng3c, torch, dev, 4 * SORT_BLOCK, keys, 1)
        if case == "all-equal keys":
            for c in lanes[:keys]:
                c.fill_(5)
        elif case == "mostly sentinel":  # the compaction's padding: count 0
            dead = torch.rand(4 * SORT_BLOCK, device=dev) < 0.9
            for c in lanes[:keys]:
                c[dead] = -1
            lanes[-1][dead] = 0
        route = cuda_sort.stage_plan(keys + 1, SORT_BLOCK).route
        check(route == ("tiled" if "tiled" in case else "cluster"), f"sort: {case} takes {route}")
        sort_err = max(sort_err, sort_matches_plain(cuda_sort, lanes, keys, SORT_BLOCK))
        log(f"[sort] block {SORT_BLOCK}, {case} ({route} route): kernel == plain")

    # --- 4. slice parity: cuda vs cpu --------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        genome = rng.integers(0, 4, size=1 << 17, dtype=np.uint8)
        reads = sample_reads(rng, genome, (4 << 20) // READ_LEN, 0.005)
        fa = os.path.join(tmp, "parity.fa")
        write_reads_fasta(fa, reads)
        stats = os.path.join(tmp, "stats.json")
        single = {}
        for k, m in ((28, 10), (32, 9)):
            res = {}
            out = {}
            for d in ("cuda", "cpu"):
                argv = [str(k), str(m), "3", "2048", "0", "0", fa, tmp + "/", "parity_",
                        "1", "0", "0", "--device", d, "--reads-per-batch", "256",
                        "--read-len", "4096", "--stats-json", stats]
                t0 = time.perf_counter()
                check(cli.main(argv) == 0, f"k={k} {d}: cli.main failed")
                res[d] = json.load(open(stats))
                out[d] = dir_bytes(res[d]["output_dir"])
                log(f"[parity] k={k} {d}: {res[d]['n_instances']} instances, "
                    f"{res[d]['n_unique']} distinct, {time.perf_counter() - t0:.2f} s")
            check(out["cuda"] == out["cpu"], f"k={k}: cuda and cpu output directories differ")
            check(res["cuda"]["n_instances"] == valid_windows(reads, k),
                  f"k={k}: instances != valid windows")
            log(f"[parity] k={k}: {len(out['cuda'])} files byte-identical")
            single[k] = res["cuda"]["output_dir"]

        # --- 4b. mesh parity: cuda vs cpu vs the single device, on half of
        # phase 4's reads (the CPU's per-batch mesh is the slow part) -------
        fah = os.path.join(tmp, "parity_half.fa")
        write_reads_fasta(fah, reads[: reads.shape[0] // 2])
        check(cli.main(["28", "10", "3", "2048", "0", "0", fah, tmp + "/", "half4_", "1", "0",
                        "0", "--device", "cuda", "--reads-per-batch", "256", "--read-len",
                        "4096", "--stats-json", stats]) == 0, "4b: the single device failed")
        single_half = json.load(open(stats))["output_dir"]
        mesh_out = {}
        for d in ("cuda", "cpu"):
            argv = ["28", "10", "3", "2048", "0", "0", fah, tmp + "/", "mesh_", "1", "0",
                    "1", "4", "--mesh", "4", "--smer-transport", "--device", d,
                    "--reads-per-batch", "256", "--read-len", "4096", "--stats-json", stats]
            t0 = time.perf_counter()
            check(cli.main(argv) == 0, f"mesh {d}: cli.main failed")
            summary = json.load(open(stats))
            mesh_out[d] = dir_bytes(summary["output_dir"])
            check(summary["placement"] == [f"{d}:0" if d == "cuda" else d] * 4,
                  f"mesh {d}: placement {summary['placement']}")
            log(f"[mesh parity] {d}: {summary['n_instances']} instances, "
                f"{summary['n_unique']} distinct, cap {summary['exchange_cap']}, "
                f"{time.perf_counter() - t0:.2f} s")
        check(mesh_out["cuda"] == mesh_out["cpu"], "mesh: cuda and cpu output directories differ")
        check(same_bin_files(summary["output_dir"], single_half),
              "mesh: bin files differ from the single-device output")
        log(f"[mesh parity] {len(mesh_out['cuda'])} files cuda == cpu; bin files == single device")

        # --- 4c. streaming mesh parity: cuda, block sort, prededup, cpu ------
        stream_out = {}
        for tag, d, extra, k, m in (("cuda", "cuda", [], 28, 10),
                                    ("cuda block sort", "cuda", [], 28, 10),
                                    ("cuda prededup on", "cuda", ["--prededup", "on"], 28, 10),
                                    ("cpu", "cpu", [], 28, 10),
                                    ("cuda k=32", "cuda", [], 32, 9)):
            argv = [str(k), str(m), "3", "2048", "0", "0", fa, tmp + "/", "stream_", "1", "0",
                    "1", "4", "--mesh", "4", "--device", d, "--reads-per-batch", "256",
                    "--read-len", "4096", "--stats-json", stats, *extra]
            cuda_sort.LAUNCHES = 0
            t0 = time.perf_counter()
            with block_sort_switch(tag == "cuda block sort"):
                check(cli.main(argv) == 0, f"stream {tag}: cli.main failed")
            summary = json.load(open(stats))
            check((cuda_sort.LAUNCHES > 0) == (tag == "cuda block sort"),
                  f"stream {tag}: {cuda_sort.LAUNCHES} block-sort launches")
            check(same_bin_files(summary["output_dir"], single[k]),
                  f"stream {tag}: bin files differ from the single-device output")
            if k == 28:
                stream_out[tag] = dir_bytes(summary["output_dir"])
            log(f"[stream parity] {tag}: {summary['n_instances']} instances, "
                f"{summary['n_unique']} distinct, exchange_bytes {summary['exchange_bytes']}, "
                f"{summary['n_dedup_batches']} dedup batches, {time.perf_counter() - t0:.2f} s")
        check(all(v == stream_out["cuda"] for v in stream_out.values()),
              "stream: the k=28 output directories differ")
        log(f"[stream parity] k=28 {len(stream_out)} runs byte-identical; bin files == single "
            "device at k=28 and k=32")
        fa4, fa4h = shutil.copy(fa, keep), shutil.copy(fah, keep)
        single4 = {k: shutil.copytree(d, os.path.join(keep, f"single{k}")) for k, d in single.items()}
        single4h = shutil.copytree(single_half, os.path.join(keep, "single_half"))

    # --- 5. the CLI at real size --------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        genome = rng.integers(0, 4, size=GENOME, dtype=np.uint8)
        reads = sample_reads(rng, genome, COVERAGE * GENOME // READ_LEN, 0.001)
        fa = os.path.join(tmp, "reads.fa")
        write_reads_fasta(fa, reads)
        expect = valid_windows(reads, 28)
        n_bases = reads.size
        # phase 6's input: the first half of the reads (half the depth)
        fa6 = os.path.join(tmp, "half.fa")
        write_reads_fasta(fa6, reads[: reads.shape[0] // 2])
        expect6 = valid_windows(reads[: reads.shape[0] // 2], 28)
        n_bases6 = reads[: reads.shape[0] // 2].size
        del genome, reads
        log(f"[real] {n_bases} bases in {COVERAGE * GENOME // READ_LEN} reads, "
            f"{expect} valid windows; data made in {time.perf_counter() - t0:.1f} s")
        stats = os.path.join(tmp, "stats.json")
        argv = ["28", "10", "3", "2048", "0", "0", fa, tmp + "/", "real_", "1", "0", "0",
                "--device", "cuda", "--reads-per-batch", "4096", "--read-len", "4096",
                "--unique-ub", str(GENOME), "--stats-json", stats]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_extract.LAUNCHES = 0
        cuda_extract.FULL_LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = cuda_extract.LAUNCHES
        check(cuda_extract.FULL_LAUNCHES == 0, "the single-device path launched the full kernel")
        peak = torch.cuda.max_memory_allocated()
        check(rc == 0, f"cli.main returned {rc}")
        summary = json.load(open(stats))
        out_dir = summary["output_dir"]
        n_batches = summary["n_batches"]
        check(n_batches >= -(-n_bases // (4096 * 4096)), f"{n_batches} batches is too few")
        check(launches >= n_batches, f"{launches} kernel launches for {n_batches} batches")
        check(api.verify_output(out_dir)["ok"], "manifest verify failed")
        n_lines, total, ascending = read_bin_table(out_dir, 28)
        check(summary["n_bases"] == n_bases, "n_bases mismatch")
        check(summary["n_instances"] == expect,
              f"n_instances {summary['n_instances']} != valid windows {expect}")
        check(total == expect, f"sum of written counts {total} != {expect}")
        check(n_lines == summary["n_unique"], "written lines != n_unique")
        check(ascending, "a bin file is not strictly ascending")
        count_s = wall - summary["timings"].get("write_output", 0.0)
        log(f"[real] {summary['n_unique']} distinct, {total} instances, "
            f"{n_batches} batches, {launches} kernel launches")
        log(f"[real] end to end {wall:.2f} s = {n_bases / wall / 1e9:.4f} Gbp/s; "
            f"without write_output {n_bases / count_s / 1e9:.4f} Gbp/s")
        log(f"[real] stage timings: {json.dumps(summary['timings'])}")
        log(f"[real] peak device memory {peak / 2**30:.2f} GiB")
        out5 = out_dir
        fa5 = shutil.copy(fa, os.path.join(keep, "reads5.fa"))  # phase 19's enableKryo job
        summary5 = {k: summary[k] for k in ("n_unique", "n_instances")}

        # --- 5b. phase 5 with the block-sort compaction ------------------------
        cuda_sort.LAUNCHES = 0
        t0 = time.perf_counter()
        with block_sort_switch(True):
            rc = cli.main([a if a != "real_" else "real5b_" for a in argv])
        check(rc == 0, f"5b: cli.main returned {rc}")
        s5b = json.load(open(stats))
        check(cuda_sort.LAUNCHES >= 1, "5b: no block-sort launch")
        check(same_bin_files(out5, s5b["output_dir"]), "5b: bin files differ from phase 5's")
        log(f"[real 5b] block-sort compaction: {time.perf_counter() - t0:.2f} s, "
            f"{cuda_sort.LAUNCHES} block-sort launches; bin files == phase 5's")
        shutil.rmtree(s5b["output_dir"])

        # --- 6. the per-batch mesh at half depth: 4 shards, all on this card,
        # held against the single device on the same half of the reads ------
        half = [a if a != fa else fa6 for a in argv]
        check(cli.main([a if a != "real_" else "half_" for a in half]) == 0, "6: single device")
        s6s = json.load(open(stats))
        out6s = s6s["output_dir"]
        argv6 = ["28", "10", "3", "2048", "0", "0", fa6, tmp + "/", "mesh_", "1", "0", "1", "4",
                 "--mesh", "4", "--smer-transport", "--device", "cuda",
                 "--reads-per-batch", "4096", "--read-len", "4096",
                 "--unique-ub", str(GENOME), "--stats-json", stats]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_extract.LAUNCHES = 0
        cuda_extract.FULL_LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(argv6)
        wall6 = time.perf_counter() - t0
        full_launches = cuda_extract.FULL_LAUNCHES
        peak6 = torch.cuda.max_memory_allocated()
        check(rc == 0, f"mesh cli.main returned {rc}")
        check(cuda_extract.LAUNCHES == 0, "the mesh path launched the count kernel")
        s6 = json.load(open(stats))
        out6 = s6["output_dir"]
        nb6 = s6["n_batches"]
        check(s6["placement"] == ["cuda:0"] * 4, f"placement {s6['placement']}")
        check(nb6 == s6s["n_batches"], f"mesh made {nb6} batches, the single device "
                                       f"{s6s['n_batches']}")
        prepass = 4 * -(-n_batches // 100)  # 1-in-100 sampling (sample_fraction 0.01)
        check(full_launches >= 4 * nb6 + 4 * -(-nb6 // 100),
              f"{full_launches} full-mode launches for {nb6} batches on 4 shards")
        check_mesh_run(s6, n_bases6, expect6, out6s, "mesh")  # out6s: kept for 12 and 13
        count6 = wall6 - s6["timings"].get("write_output", 0.0)
        log(f"[mesh real] half depth ({n_bases6} bases): {s6['n_unique']} distinct, {expect6} "
            f"instances, {nb6} batches, {full_launches} full-mode launches; bin files == the "
            f"single device's on the same reads ({s6s['n_unique']} distinct)")
        log(f"[mesh real] end to end {wall6:.2f} s = {n_bases6 / wall6 / 1e9:.4f} Gbp/s; "
            f"without write_output {n_bases6 / count6 / 1e9:.4f} Gbp/s (4 shards on one card)")
        log(f"[mesh real] stage timings: {json.dumps(s6['timings'])}")
        log(f"[mesh real] exchange_bytes {s6['exchange_bytes']}, final cap "
            f"{s6['exchange_cap']}, retries {s6['exchange_retries']}, "
            f"balance {json.dumps(s6['balance'])}")
        log(f"[mesh real] peak device memory {peak6 / 2**30:.2f} GiB")
        shutil.rmtree(out6)

        # --- 7 / 7b. the streaming mesh at real size, without and with the
        # block-sort compaction; each path's counts are zeroed just before it
        for phase in ("7", "7b"):
            argv7 = ["28", "10", "3", "2048", "0", "0", fa, tmp + "/", f"stream{phase}_", "1",
                     "0", "1", "4", "--mesh", "4", "--device", "cuda",
                     "--reads-per-batch", "4096", "--read-len", "4096",
                     "--unique-ub", str(GENOME), "--stats-json", stats]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = cuda_sort.LAUNCHES = 0
            t0 = time.perf_counter()
            with block_sort_switch(phase == "7b"):
                rc = cli.main(argv7)
            wall7 = time.perf_counter() - t0
            full7, sort7 = cuda_extract.FULL_LAUNCHES, cuda_sort.LAUNCHES
            peak7 = torch.cuda.max_memory_allocated()
            check(rc == 0, f"{phase}: cli.main returned {rc}")
            check(cuda_extract.LAUNCHES == 0, f"{phase}: the mesh launched the count kernel")
            s7 = json.load(open(stats))
            nb7 = s7["n_batches"]
            check(nb7 == n_batches, f"{phase}: {nb7} batches, the single device {n_batches}")
            check(full7 >= 4 * nb7 + prepass,
                  f"{phase}: {full7} full-mode launches for {nb7} batches on 4 shards")
            merges = -(-nb7 // 4)  # at least one merge per fan-in window of 4
            if phase == "7":
                check(sort7 == 0, f"7: {sort7} block-sort launches with the switch off")
                stream_full = full7
            else:
                check(sort7 >= 4 * merges, f"7b: {sort7} block-sort launches for "
                                           f"at least {merges} merges on 4 shards")
                stream_sort = sort7
            check_mesh_run(s7, n_bases, expect, out5, phase)
            if phase == "7":  # phase 17 holds its multi-process run against it
                s7_run = {**s7, "wall": wall7}
            else:
                shutil.rmtree(s7["output_dir"])
            count7 = wall7 - s7["timings"].get("write_output", 0.0)
            log(f"[stream {phase}] {s7['n_unique']} distinct, {nb7} batches, {full7} full-mode "
                f"launches, {sort7} block-sort launches; bin files == phase 5's")
            log(f"[stream {phase}] end to end {wall7:.2f} s = {n_bases / wall7 / 1e9:.4f} Gbp/s; "
                f"without write_output {n_bases / count7 / 1e9:.4f} Gbp/s (4 shards on one card)")
            log(f"[stream {phase}] stage timings: {json.dumps(s7['timings'])}")
            log(f"[stream {phase}] exchange_bytes {s7['exchange_bytes']}, n_dedup_batches "
                f"{s7['n_dedup_batches']}, cap {s7['exchange_cap']}, retries "
                f"{s7['exchange_retries']}, balance {json.dumps(s7['balance'])}")
            log(f"[stream {phase}] peak device memory {peak7 / 2**30:.2f} GiB")

        # --- 11. single-device HT at phase 5's workload ------------------------
        t11 = time.perf_counter()
        stats = os.path.join(tmp, "stats.json")
        argv11 = ["28", "10", "3", "2048", "1", "0", fa, tmp + "/", "ht_", "1", "0", "0",
                  "--device", "cuda", "--reads-per-batch", "4096", "--read-len", "4096",
                  "--stats-json", stats]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(argv11)  # a fingerprint collision would raise here
        wall11 = time.perf_counter() - t0
        ht_launches = cuda_extract.LAUNCHES
        peak11 = torch.cuda.max_memory_allocated()
        check(rc == 0, f"11: cli.main returned {rc}")
        check(cuda_extract.FULL_LAUNCHES == 0, "11: the single-device HT path launched kernel B")
        s11 = json.load(open(stats))
        out11 = s11["output_dir"]
        check(s11["engine"] == "hash" and s11["n_batches"] == n_batches,
              f"11: engine {s11['engine']}, {s11['n_batches']} batches, phase 5 {n_batches}")
        check(ht_launches == n_batches, f"11: {ht_launches} kernel A launches for {n_batches} batches")
        check(api.verify_output(out11)["ok"], "11: manifest verify failed")
        n_lines, total, ascending = read_bin_table(out11, 28, eof=False)
        check(s11["n_instances"] == expect == total,
              f"11: n_instances {s11['n_instances']}, written {total}, valid windows {expect}")
        check(n_lines == s11["n_unique"] == summary["n_unique"], "11: written lines != n_unique")
        check(ascending, "11: a bin file is not strictly ascending")
        check(same_bins_but_eof(out5, out11), "11: bin files differ from phase 5's but for EOF")
        count11 = wall11 - s11["timings"].get("write_output", 0.0)
        log(f"[ht 11] {s11['n_unique']} distinct, {n_batches} batches, {ht_launches} kernel A "
            f"launches, no collision; bin files == phase 5's without EOF")
        log(f"[ht 11] end to end {wall11:.2f} s = {n_bases / wall11 / 1e9:.4f} Gbp/s; without "
            f"write_output {n_bases / count11 / 1e9:.4f} Gbp/s (phase 5, sort engine: "
            f"{wall:.2f} s)")
        log(f"[ht 11] stage timings: {json.dumps(s11['timings'])}")
        log(f"[ht 11] peak device memory {peak11 / 2**30:.2f} GiB")
        for k, m in ((55, 9), (32, 9)):  # the murmur mix (W = 4); the flag lane
            ht4 = {}
            for d in ("cuda", "cpu"):
                argv = [str(k), str(m), "3", "2048", "1", "0", fa4, tmp + "/", "ht4_", "1", "0",
                        "0", "--device", d, "--reads-per-batch", "256", "--read-len", "4096",
                        "--stats-json", stats]
                check(cli.main(argv) == 0, f"11: HT k={k} {d}: cli.main failed")
                ht4[d] = dir_bytes(json.load(open(stats))["output_dir"])
            check(ht4["cuda"] == ht4["cpu"], f"11: HT k={k}: cuda and cpu directories differ")
            if k in single4:
                check(same_bins_but_eof(single4[k], json.load(open(stats))["output_dir"]),
                      f"11: HT k={k}: bin files differ from phase 4's but for EOF")
            log(f"[ht 11] phase 4's FASTA, k={k}: {len(ht4['cuda'])} files cuda == cpu")
        log(f"[ht 11] phase 11 {time.perf_counter() - t11:.2f} s")

        # --- 12. HT on the per-batch mesh -----------------------------------
        t12 = time.perf_counter()
        argv12 = ["28", "10", "3", "2048", "1", "0", fa6, tmp + "/", "meshht_", "1", "0", "1", "4",
                  "--mesh", "4", "--device", "cuda", "--reads-per-batch", "4096",
                  "--read-len", "4096", "--unique-ub", str(GENOME), "--stats-json", stats]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(argv12)
        wall12 = time.perf_counter() - t0
        ht_full = cuda_extract.FULL_LAUNCHES
        peak12 = torch.cuda.max_memory_allocated()
        check(rc == 0, f"12: cli.main returned {rc}")
        check(cuda_extract.LAUNCHES == 0, "12: the mesh HT path launched kernel A")
        s12 = json.load(open(stats))
        nb12 = s12["n_batches"]
        check(s12["engine"] == "hash" and nb12 == s6s["n_batches"], f"12: {nb12} batches")
        check(ht_full >= 4 * nb12 + 4 * -(-nb12 // 100),
              f"12: {ht_full} kernel B launches for {nb12} batches on 4 shards")
        check(api.verify_output(s12["output_dir"])["ok"], "12: manifest verify failed")
        check(s12["n_instances"] == expect6, f"12: n_instances {s12['n_instances']} != {expect6}")
        check(same_bins_but_eof(out6s, s12["output_dir"]),
              "12: bin files differ from phase 6's single device but for EOF")
        shutil.rmtree(s12["output_dir"])
        count12 = wall12 - s12["timings"].get("write_output", 0.0)
        log(f"[ht 12] mesh at half depth: {s12['n_unique']} distinct, {nb12} batches, {ht_full} "
            "kernel B launches; bin files == phase 6's single device without EOF")
        log(f"[ht 12] end to end {wall12:.2f} s = {n_bases6 / wall12 / 1e9:.4f} Gbp/s; without "
            f"write_output {n_bases6 / count12 / 1e9:.4f} Gbp/s (4 shards on one card)")
        log(f"[ht 12] stage timings: {json.dumps(s12['timings'])}; exchange_bytes "
            f"{s12['exchange_bytes']}, cap {s12['exchange_cap']}, retries {s12['exchange_retries']}")
        log(f"[ht 12] peak device memory {peak12 / 2**30:.2f} GiB")
        smer_ht = {}
        for d in ("cuda", "cpu"):
            argv = ["28", "10", "3", "2048", "1", "0", fa4h, tmp + "/", "smerht_", "1", "0", "1",
                    "4", "--mesh", "4", "--smer-transport", "--device", d, "--reads-per-batch",
                    "256", "--read-len", "4096", "--stats-json", stats]
            check(cli.main(argv) == 0, f"12: smer HT {d}: cli.main failed")
            smer_ht[d] = dir_bytes(json.load(open(stats))["output_dir"])
        check(smer_ht["cuda"] == smer_ht["cpu"], "12: smer HT cuda and cpu directories differ")
        check(same_bins_but_eof(single4h, json.load(open(stats))["output_dir"]),
              "12: smer HT bin files differ from phase 4b's single device but for EOF")
        log(f"[ht 12] --smer-transport useHT=1 on phase 4b's half: {len(smer_ht['cuda'])} files "
            f"cuda == cpu; phase 12 {time.perf_counter() - t12:.2f} s")

        # --- 13. durability at phase 5's workload --------------------------------
        t13 = time.perf_counter()
        ck = os.path.join(tmp, "ckpt")
        names5, man5 = sorted(os.listdir(out5)), manifest_bytes(out5)
        names11, man11 = sorted(os.listdir(out11)), manifest_bytes(out11)
        cfg13 = JobConfig(**json.loads(man5)["config"])  # phase 5's run, as its manifest says
        res13, t_resume, t_die = interrupt_and_resume(
            lambda: pipeline.execute_job(cfg13, verbose=False, device="cuda", checkpoint_dir=ck,
                                         checkpoint_interval=4, unique_ub=GENOME),
            ck, 0, 8, "13 single")
        check(same_dir_as(out5, man5, names5), "13: the resumed directory differs from phase 5's")
        log(f"[durable 13] single device: interrupted after batch 10 in {t_die:.2f} s; resumed "
            f"from batch 8 in {t_resume:.2f} s, merge (2 persisted spills + the rest) "
            f"{res13.timings['merge']:.3f} s, checkpoint {res13.timings.get('checkpoint', 0):.3f} "
            f"s; directory == phase 5's")
        argv13 = ["28", "10", "3", "2048", "0", "0", fa6, tmp + "/", "stream13_", "1", "0", "1",
                  "4", "--mesh", "4", "--device", "cuda", "--reads-per-batch", "4096",
                  "--read-len", "4096", "--unique-ub", str(GENOME), "--stats-json", stats,
                  "--checkpoint-dir", ck, "--checkpoint-interval", "4"]
        _, t_resume, t_die = interrupt_and_resume(lambda: cli.main(argv13), ck, 1, 4,
                                                  "13 stream", at=6)
        s13 = json.load(open(stats))
        check(s13["n_instances"] == expect6 and same_bin_files(out6s, s13["output_dir"]),
              "13: the resumed streaming mesh's bin files differ from phase 6's single device")
        shutil.rmtree(s13["output_dir"])
        shutil.rmtree(out6s)
        log(f"[durable 13] streaming mesh at half depth: interrupted after batch 6 in "
            f"{t_die:.2f} s, resumed from batch 4 in {t_resume:.2f} s, merge "
            f"{s13['timings']['merge']:.3f} s, checkpoint {s13['timings'].get('checkpoint', 0):.3f}"
            f" s; bin files == phase 6's single device")
        argv13 = argv11 + ["--checkpoint-dir", ck, "--checkpoint-interval", "4", "--keep-table"]
        _, t_resume, t_die = interrupt_and_resume(lambda: cli.main(argv13), ck, 0, 10, "13 HT")
        s13 = json.load(open(stats))
        check(same_dir_as(out11, man11, names11, (manifest.TABLE_SIDECAR,)),
              "13: the resumed HT directory differs from phase 11's")
        log(f"[durable 13] HT, the per-batch flow: interrupted in {t_die:.2f} s, resumed from "
            f"batch 10 in {t_resume:.2f} s, merge {s13['timings']['merge']:.3f} s; directory "
            "== phase 11's + table.npz")
        victim = os.path.join(out11, sorted(n for n in names11 if n.startswith("bin"))[7])
        with open(victim, "r+b") as f:
            head = f.read(40)
            pos = head.index(b"\t") + 1
            f.seek(pos)
            f.write(b"1" if head[pos:pos + 1] != b"1" else b"2")
        check(not api.verify_output(out11)["ok"], "13: verify missed the corrupted bin")
        cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = cuda_sort.LAUNCHES = 0
        t0 = time.perf_counter()
        status = pipeline.repair_output(JobConfig(**json.loads(man11)["config"]), verbose=False)
        t_repair = time.perf_counter() - t0
        check(status["ok"], f"13: repair failed: {status}")
        check(cuda_extract.LAUNCHES + cuda_extract.FULL_LAUNCHES + cuda_sort.LAUNCHES == 0,
              "13: the repair launched a kernel (it recounted)")
        check(same_dir_as(out11, man11, names11, (manifest.TABLE_SIDECAR,)),
              "13: the repaired directory differs from phase 11's")
        log(f"[durable 13] repair from table.npz: {t_repair:.2f} s, 0 kernel launches; "
            "directory restored byte for byte")
        trace = os.path.join(tmp, "trace")
        argv = ["28", "10", "3", "2048", "0", "0", fa4, tmp + "/", "trace_", "1", "0", "0",
                "--device", "cuda", "--reads-per-batch", "256", "--read-len", "4096",
                "--trace-dir", trace]
        t0 = time.perf_counter()
        check(cli.main(argv) == 0, "13: the traced run failed")
        t_trace = time.perf_counter() - t0
        trace_file = os.path.join(trace, TRACE_FILE)
        check(os.path.getsize(trace_file) > 0, "13: no trace file")
        events = json.load(open(trace_file)).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"[durable 13] --trace-dir on phase 4's FASTA: {os.path.getsize(trace_file)} bytes, "
            f"{len(events)} events, {kernels} kernel events, {t_trace:.2f} s")
        log(f"[durable 13] phase 13 {time.perf_counter() - t13:.2f} s")

        # --- 17. phase 7 across processes, then per batch with enableKryo ----
        rank_full = multihost_phase(tmp, fa, s7_run["output_dir"], s7_run, fa4, single4[28])
        shutil.rmtree(s7_run["output_dir"])

    # --- 7b timing: one full merge window of phase 7b, fan-in 4 parts of
    # 4 shards x cap rows plus the accumulator (the driver's default acc_cap)
    positions = 1024 * (4096 - 28 + 1)
    acc_cap = 1 << max(14, (2 * 4 * positions - 1).bit_length())
    n_sort = -(-(4 * 4 * s7["exchange_cap"] + acc_cap) // SORT_BLOCK) * SORT_BLOCK
    lanes = sort_lanes(np.random.default_rng(77), torch, dev, n_sort, 2, 1)
    # the kernel against its plain version at this shape too: only here does
    # a device-memory stage loop over the grid, and thousands of tiles run
    sort_err = max(sort_err, sort_matches_plain(cuda_sort, lanes, 2, SORT_BLOCK))
    log(f"[sort] [{n_sort}] rows x 3 lanes, block {SORT_BLOCK}: kernel == plain")
    # the in-place kernel alone, on a fresh unsorted copy each time
    src = torch.stack(lanes)
    buf = torch.empty_like(src)
    sort_ms = time_ms(lambda: cuda_sort.sort_blocks_(buf, 2, SORT_BLOCK), 5,
                      setup=lambda: buf.copy_(src))
    del src, buf
    sort_plain_ms = time_ms(lambda: cuda_sort.sort_blocks_reference(lanes, 2, SORT_BLOCK), 3)
    key = pair_key(lanes[0], lanes[1]).view(-1, SORT_BLOCK)
    sort_lib_ms = time_ms(lambda: torch.sort(key, dim=1), 5)
    del lanes, key
    sort_bound_ms = n_sort * 3 * 4 * 2 / HBM_BYTES_PER_S * 1e3
    log(f"[sort] [{n_sort}] rows x 3 lanes, block {SORT_BLOCK}: kernel {sort_ms:.4f} ms, "
        f"plain {sort_plain_ms:.4f} ms, torch.sort of the packed key {sort_lib_ms:.4f} ms, "
        f"bound {sort_bound_ms:.4f} ms")

    # --- 8. kernel E, the pass probes, vs plain on the card ---------------------
    t8 = time.perf_counter()
    gen8 = torch.Generator(dev).manual_seed(8)
    pass_err = 0
    passes = [("copy_pass", cuda_probe.copy_pass), ("transpose_pass", cuda_probe.transpose_pass)]
    for case, n in (("2^14", 1 << 14), ("2^24", 1 << 24), ("131 tiles", 131 << 14),
                    ("0xFFFFFFFF entries", 1 << 15)):
        a, b = (rand_i32(gen8, n, dev).view(-1, 128) for _ in range(2))
        if case == "0xFFFFFFFF entries":
            a[:, ::7] = -1
            b[0] = -1
        for name, fn in passes:
            got = fn(a, b)
            torch.cuda.synchronize()
            for g, x in zip(got, (a, b)):
                r = cuda_probe.pass_reference(x)
                pass_err = max(pass_err, int((g.to(torch.int64) - r.to(torch.int64)).abs().max()))
                check(torch.equal(g, r), f"{name} != plain at {case}")
            if case == "0xFFFFFFFF entries":
                check(int(got[0][0, 0]) == 0 and int(got[1][0, 5]) == 0,
                      f"{name}: 0xFFFFFFFF did not wrap")
        log(f"[pass] copy and transpose == plain at {case} ([{n // 128}, 128] x 2)")
        if case == "2^24":
            copy_ms = time_ms(lambda: cuda_probe.copy_pass(a, b), 50)
            tr_ms = time_ms(lambda: cuda_probe.transpose_pass(a, b), 50)
            pass_plain_ms = time_ms(lambda: (cuda_probe.pass_reference(a),
                                             cuda_probe.pass_reference(b)), 10)
            pass_lib_ms = time_ms(lambda: (a + 1, b + 1), 50)

            def lib_round_trip(x):  # the library's transpose, + 1, and back
                t = x.view(-1, 128, 128).transpose(1, 2).contiguous() + 1
                return t.transpose(1, 2).contiguous()

            lib_tr_ms = time_ms(lambda: (lib_round_trip(a), lib_round_trip(b)), 20)
    del a, b, got
    pass_bound_ms = 2 * 2 * (1 << 24) * 4 / HBM_BYTES_PER_S * 1e3
    log(f"[pass] 2^24 x 2 lanes: copy {copy_ms:.4f} ms, transpose {tr_ms:.4f} ms, plain {pass_plain_ms:.4f} ms, int32 a + 1 "
        f"{pass_lib_ms:.4f} ms, library transpose round trip {lib_tr_ms:.4f} ms, bound "
        f"{pass_bound_ms:.4f} ms (copy {2 * 2 * (1 << 24) * 4 / copy_ms / 1e6:.1f} GB/s, "
        f"transpose {pass_bound_ms / tr_ms:.1%} of the bound); phase 8 "
        f"{time.perf_counter() - t8:.2f} s")

    # --- 9. kernel D, the bitonic merge, vs plain on the card ----------------------
    t9 = time.perf_counter()
    rng9 = np.random.default_rng(9)
    merge_err = 0
    for n in (1 << 11, 1 << 15, 1 << 17):
        for keys in (1, 2, 3):
            for vals in (0, 1):
                lanes = sort_lanes(rng9, torch, dev, n, keys, vals)
                merge_err = max(merge_err, merge_matches_plain(cuda_bitonic_merge, count_sort,
                                                               lanes, keys))
        log(f"[merge] {n} rows (tile {cuda_bitonic_merge.merge_tile(3, n)} at 3 lanes): "
            "kernel == plain for 1-3 keys, with and without a value")
    for case in ("all-equal keys", "mostly sentinel"):
        lanes = sort_lanes(rng9, torch, dev, 1 << 17, 2, 1)
        if case == "all-equal keys":
            for c in lanes[:2]:
                c.fill_(5)
        else:  # the resume probe's padding: sentinel keys of count 0
            dead = torch.rand(1 << 17, device=dev) < 0.9
            for c in lanes[:2]:
                c[dead] = -1
            lanes[-1][dead] = 0
        merge_err = max(merge_err, merge_matches_plain(cuda_bitonic_merge, count_sort, lanes, 2))
        log(f"[merge] {1 << 17} rows, {case}: kernel == plain")
    n16 = 1 << 16  # 32 tiles of merge_tile(3, n16) = 2048 rows
    idx = torch.arange(n16, dtype=torch.int32, device=dev)
    for case in ("A below B", "B below A", "runs longer than a tile"):
        lanes = sort_lanes(rng9, torch, dev, n16, 2, 1)
        if case == "A below B":  # tiles wholly from A, then wholly from B
            lanes[0].copy_(idx % 1000 + 5000 * (idx >= n16 // 2))
        elif case == "B below A":
            lanes[0].copy_(idx % 1000 + 5000 * (idx < n16 // 2))
        else:  # runs of 8192 rows, A's and B's alternating
            lanes[0].copy_((idx % (n16 // 2)) // 8192 * 2 + (idx >= n16 // 2).to(torch.int32))
        merge_err = max(merge_err, merge_matches_plain(cuda_bitonic_merge, count_sort, lanes, 2))
        log(f"[merge] {n16} rows, {case}: kernel == plain")
    n_merge = 1 << 27  # split_merge_probe's shape: 2 keys + 1 value
    gen9 = torch.Generator(dev).manual_seed(9)
    lanes = (rand_i32(gen9, n_merge, dev), rand_i32(gen9, n_merge, dev),
             rand_i32(gen9, n_merge, dev, 1, 3))
    merge_err = max(merge_err, merge_matches_plain(cuda_bitonic_merge, count_sort, lanes, 2))
    log(f"[merge] [{n_merge}] rows x 3 lanes: kernel == plain, keys == torch.sort's")
    src = cuda_bitonic_merge.bitonic_input(lanes, 2)
    del lanes
    # the kernel's two launches into a preallocated buffer and scratch
    out = torch.empty_like(src)
    splits = torch.empty(n_merge // cuda_bitonic_merge.merge_tile(3, n_merge) + 1,
                         dtype=torch.int64, device=dev)
    merge_ms = time_ms(lambda: cuda_bitonic_merge.merge_into(src, out, splits, 2), 10)
    # the in-place form, its copy back included, on a fresh copy each call
    buf = out
    merge_inplace_ms = time_ms(lambda: cuda_bitonic_merge.bitonic_merge_(buf, 2, 1 << 16), 10,
                               setup=lambda: buf.copy_(src))
    del buf, out, splits
    merge_plain_ms = time_ms(
        lambda: cuda_bitonic_merge.bitonic_merge_reference(tuple(src), 2, 1 << 16), 3)
    key = pair_key(src[0], src[1])
    merge_lib_ms = time_ms(lambda: torch.sort(key), 5)
    del src, key
    merge_bound_ms = n_merge * 3 * 4 * 2 / HBM_BYTES_PER_S * 1e3
    log(f"[merge] [{n_merge}] rows x 3 lanes: kernel {merge_ms:.4f} ms (partition + merge), "
        f"in place {merge_inplace_ms:.4f} ms, plain {merge_plain_ms:.4f} ms, torch.sort of the "
        f"packed key {merge_lib_ms:.4f} ms, bound {merge_bound_ms:.4f} ms "
        f"({merge_bound_ms / merge_ms:.1%}); phase 9 {time.perf_counter() - t9:.2f} s")

    # --- 10. the probes on the card; each probe's counts are zeroed just
    # before it and read just after
    t10 = time.perf_counter()
    cuda_bitonic_merge.LAUNCHES = 0
    lines = split_merge_probe.run(27)
    split_launches = cuda_bitonic_merge.LAUNCHES
    check(lines[0]["keys_ok"] and lines[0]["rows_multiset_ok"], "split_merge: not exact")
    check(len(lines) == 4 and all(x["marginal_s"] > 0 for x in lines[1:]),
          f"split_merge: {len(lines)} lines")
    check(split_launches > 0, "split_merge launched no bitonic merge")
    cuda_bitonic_merge.LAUNCHES = 0
    res = resume_merge_probe.run()
    resume_launches = cuda_bitonic_merge.LAUNCHES
    check(resume_launches > 0, "resume_merge launched no bitonic merge")
    check(res["host_s"] > 0 and res["device_roundtrip_s"] > 0 and res["kernel_ms"] > 0,
          f"resume_merge: {res}")
    cuda_probe.COPY_LAUNCHES = cuda_probe.TRANSPOSE_LAUNCHES = 0
    probes = cuda_probe.run(24)
    copy_launches, tr_launches = cuda_probe.COPY_LAUNCHES, cuda_probe.TRANSPOSE_LAUNCHES
    check(copy_launches > 0 and tr_launches > 0, "cuda_probe launched no pass kernel")
    check([p["probe"] for p in probes] == ["copy_pass", "transpose_pass"], "cuda_probe lines")
    cuda_extract.LAUNCHES = 0
    ms_lines = multiseq_probe.run()
    # a (k-mer, seq) pair per distinct k-mer at least
    check(ms_lines[1]["n_unique"] >= ms_lines[0]["n_unique"] > 0,
          f"multiseq_probe: {ms_lines[1]['n_unique']} pairs, {ms_lines[0]['n_unique']} k-mers")
    check(cuda_extract.LAUNCHES > 0, "multiseq_probe launched no kernel A")
    for line in ms_lines:
        log(f"[probes] multiseq_probe {json.dumps(line)}")
    for name in ("multisequence.SquaredEuclidean", "multisequence.KLDLog2"):
        for line in distance_probe.run(name):  # raises past 1e-4 relative
            log(f"[probes] distance_probe {json.dumps(line)}")
    def arms_check(name: str, lines: list) -> None:
        """Each plain arm launched no kernel, each kernel arm did."""
        arms = [x for x in lines if "arm" in x]
        check(arms and all((x["kernel_launches"] > 0) == (x["arm"] == "kernel") for x in arms),
              f"{name}: launches by arm {[(x['arm'], x['kernel_launches']) for x in arms]}")

    def bigk_check(lines: list) -> None:
        arms_check("bigk_probe", lines)
        check(sorted({x["k"] for x in lines if x["arm"] == "kernel"})
              == sorted(k for k, _ in bigk_probe.KMS), "bigk_probe: a k has no kernel arm")

    def sort_check(lines: list) -> None:
        check(lines[0]["keys_ok"] and lines[0]["vals_multiset_ok"]
              and lines[0]["rows"] == pallas_sort_probe.NV, f"pallas_sort_probe: {lines[0]}")

    def scaling_check(lines: list) -> None:
        check([x["mesh"] for x in lines] == list(scaling.MESH_SIZES)
              and all(x["dropped"] == 0 for x in lines), "scaling: a mesh size dropped rows")

    # the bench-layer probes and the probes of kernels A, B and C at small
    # sizes, each with its kernel (and its own check of the lines)
    layer_probes = (
        ("e2e", lambda: e2e.run(4, 4, 26), "A", None),
        ("mesh_dedup_probe", lambda: mesh_dedup_probe.run(4, 1024, 1024, 1 << 18, 4, 4), "B",
         None),
        ("merge_probe", lambda: merge_probe.run(1 << 23, 1 << 20, 1 << 20, iters=3), "C", None),
        ("stream_probe", lambda: stream_probe.run(n_batch=4), "A", None),
        ("skew", lambda: skew.run(), "B", None),
        ("bigk_probe", lambda: bigk_probe.run(R=64), "A", bigk_check),
        ("smer_pallas_probe", lambda: smer_pallas_probe.run(iters=1, R=64), "B",
         lambda lines: arms_check("smer_pallas_probe", lines)),
        ("pallas_sort_probe", lambda: pallas_sort_probe.run(20, [1 << 15]), "C", sort_check),
        ("scaling", lambda: scaling.run(), "B", scaling_check),
    )
    probe_launches = {}
    for name, fn, kernel, check_lines in layer_probes:
        cuda_extract.LAUNCHES = cuda_extract.FULL_LAUNCHES = cuda_sort.LAUNCHES = 0
        t_probe = time.perf_counter()
        line = fn()
        n = {"A": cuda_extract.LAUNCHES, "B": cuda_extract.FULL_LAUNCHES,
             "C": cuda_sort.LAUNCHES}[kernel]
        check(n > 0, f"{name} launched no kernel {kernel}")
        if check_lines is not None:
            check_lines(line)
        probe_launches[name] = n
        log(f"[probes] {name} ({time.perf_counter() - t_probe:.2f} s): {json.dumps(line)}")
    log(f"[probes] bitonic merge launches: split_merge {split_launches}, resume_merge "
        f"{resume_launches}; pass launches: copy {copy_launches}, transpose {tr_launches}; "
        f"bench-layer and kernel probes' launches {probe_launches}; "
        f"phase 10 {time.perf_counter() - t10:.2f} s")

    # --- 14-16. multiseq: small, cuda against cpu; at real size on the
    # single device and the streaming mesh --------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ms_small = multiseq_small(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        ms_real = multiseq_real(tmp)

    # --- 18. the bench and entry layer: the bench, entry() and the dry run ----
    bench18 = bench_entry_phase(cuda_extract)

    # --- 19. the card's deflate of counts.npz ---------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        deflate19 = deflate_phase(rng, tmp, fa5, summary5)

    log(f"[smoke] every phase passed in {time.perf_counter() - t_run:.1f} s")
    # bounds: each input byte read once, each output byte written once
    rp = 4096 * (4096 - 28 + 1)
    kernels = [
        ("extract_count", "fastkmer_tpu/ops/pallas_extract.py:262 (extract_pallas_sentinel, "
         '_mk_kernel mode="count")', launches, max_err, kernel_ms, plain_ms,
         count_bound_ms, None, "extract.cu"),
        ("extract_full", 'fastkmer_tpu/ops/pallas_extract.py:215 (extract_pallas, _mk_kernel '
         'mode="full")', stream_full, full_err, full_ms, full_plain_ms,
         (4096 * 4096 + (4 * 4 + 1) * rp) / HBM_BYTES_PER_S * 1e3, None, "extract.cu"),
        ("block_sort", "fastkmer_tpu/ops/pallas_sort.py:150 (sort_blocks, "
         "_mk_block_sort_kernel)", stream_sort, sort_err, sort_ms, sort_plain_ms,
         sort_bound_ms, sort_lib_ms, "block_sort.cu"),
        ("pass_copy", "benchmarks/pallas_probe.py:47 (copy_kernel)", copy_launches, pass_err,
         copy_ms, pass_plain_ms, pass_bound_ms, pass_lib_ms, "pass_probe.cu"),
        ("pass_transpose", "benchmarks/pallas_probe.py:54 (tr_kernel)", tr_launches, pass_err,
         tr_ms, pass_plain_ms, pass_bound_ms, pass_lib_ms, "pass_probe.cu"),
        ("bitonic_merge", "benchmarks/pallas_bitonic_merge.py:116 (bitonic_merge, "
         "_mk_cross_kernel + _mk_clean_kernel)", split_launches + resume_launches, merge_err,
         merge_ms, merge_plain_ms, merge_bound_ms, merge_lib_ms, "bitonic_merge.cu"),
        ("deflate", "none: the JAX package writes counts.npz with np.savez_compressed "
         "(fastkmer_tpu/output/writer.py:151)", deflate19["launches"], deflate19["err"],
         deflate19["ms"],
         deflate19["plain_ms"], deflate19["bound_ms"], None, "deflate.cu"),
    ]
    # launches on each path that runs a kernel: A on the single device (5,
    # 11 under useHT=1, 14-15 multiseq), B on the meshes (7 streaming, 12 HT
    # per batch, 14 and 16 multiseq, 17 streaming across processes: the
    # ranks' own counts summed)
    by_phase = {"extract_count": {"5": launches, "11": ht_launches, "14": ms_small["A"],
                                  "15": ms_real["A"], "18": bench18["A"]},
                "extract_full": {"7": stream_full, "12": ht_full, "14": ms_small["B"],
                                 "16": ms_real["B"], "17": rank_full, "18": bench18["B"]}}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"fastkmer_tpu_torch/csrc/{src}",
        "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": lib,
        "bound_share": bound / ms if ms else None,
        **({"launches_by_phase": by_phase[name]} if name in by_phase else {}),
        **(deflate19["extra"] if name == "deflate" else {}),
    } for name, replaces, n, err, ms, pms, bound, lib, src in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
