"""Smoke run of fastkmer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``fastkmer_tpu_torch/csrc`` (one nvcc per
source, started together) and drives the port's three paths: the
single-chip sort-engine count job, the per-batch mesh count job with
super-k-mer transport, and the streaming mesh counter (the default of
``--mesh N``).  Each phase raises on failure, so the process exits non-zero:

1. card: needs ``torch.cuda.is_available()``; prints nvidia-smi's name and
   power limit;
2. build: compiles the kernels with nvcc and prints the seconds taken;
3. kernel vs plain: the extract kernel against its plain torch version on
   the card (``torch.equal``) for every listed (k, m), at [512, 4096] and a
   ragged [3, k+5], and at phase 5's [4096, 4096] for k=28, where both are
   timed with CUDA events;
3b. full-mode kernel vs plain: ``extract_full`` against ``extract.extract``
   on the card for the same (k, m) and shapes: ``valid`` equal, words, sigs
   and bins equal where valid, bins in [0, B) everywhere; both timed at
   [4096, 4096] for k in {28, 31, 55, 97, 155};
3c. block sort vs plain: ``cuda_sort.sort_blocks`` against
   ``sort_blocks_reference`` on the card for 1-4 keys, with and without a
   value lane, at blocks 1024, 8192 and 32768: keys equal (``torch.equal``)
   and each block's rows equal as a multiset;
4. slice parity: the CLI entry (``cli.main``) on a seeded ~4 Mbp FASTA
   with Ns, at k=28 and k=32, with ``--device cuda`` and ``--device cpu``;
   the output directories must be identical;
4b. mesh parity: ``cli.main --mesh 4 --smer-transport`` with LPT placement
   (``useCustomPartitioner=1 4``) on phase 4's FASTA at k=28, with
   ``--device cuda`` (all four shards on ``cuda:0``) and ``--device cpu``:
   identical output directories, and bin files identical to phase 4's;
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
6. the mesh at real size: phase 5's FASTA and arguments through
   ``cli.main --mesh 4 --smer-transport`` with ``useCustomPartitioner=1 4``,
   all four shards on one card: phase 5's checks, bin files identical to
   phase 5's, and at least four full-mode launches per batch plus the
   pre-pass's;
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
   (the library yardstick) are timed.

The script imports only the port (``fastkmer_tpu_torch``), torch and numpy.

The line before the last is one JSON object with the kernels' launches,
errors, times and bounds; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA's data sheet)
SORT_BLOCK = 1 << 15  # the merges' compaction block (pipeline._acc_merge)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def random_codes(rng, R: int, L: int, invalid: float = 0.01) -> np.ndarray:
    codes = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
    codes[rng.random((R, L)) < invalid] = 4
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


def valid_windows(reads: np.ndarray, k: int) -> int:
    """Windows of k bases with no N, counted on the host."""
    bad = np.zeros((reads.shape[0], reads.shape[1] + 1), np.int16)
    np.cumsum(reads >= 4, axis=1, out=bad[:, 1:])
    return int(((bad[:, k:] - bad[:, :-k]) == 0).sum())


def dir_bytes(d: str) -> dict[str, bytes]:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def read_bin_table(out_dir: str, k: int):
    """Parse every bin file: -> (lines, sum of counts, all files strictly
    ascending).  k <= 32, so a k-mer packs into one uint64 key."""
    n_lines, total, ascending = 0, 0, True
    for name in os.listdir(out_dir):
        if not name.startswith("bin"):
            continue
        data = np.fromfile(os.path.join(out_dir, name), np.uint8)
        check(data[-3:].tobytes() == b"EOF", f"{name}: no EOF sentinel")
        data = data[:-3]
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


def time_ms(fn, iters: int, setup=None) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events, warmed up);
    ``setup`` runs before each call, outside the timed span."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def check_mesh_run(summary: dict, n_bases: int, expect: int, out5: str, tag: str) -> None:
    """Phase 5's checks on a mesh run of phase 5's workload, and bin files
    equal to phase 5's."""
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
    check(same_bin_files(out5, out), f"{tag}: bin files differ from phase 5's")


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
        from fastkmer_tpu_torch.core.tbits import pair_key
        from fastkmer_tpu_torch.ops import cuda_extract, cuda_sort, extract
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script ({e})", file=sys.stderr)
        return 1

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

    # --- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        list(pool.map(lambda build: build(), (cuda_extract.library, cuda_sort.library)))
    log(f"[build] extract and block sort kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

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
    big = torch.from_numpy(random_codes(rng, 4096, 4096)).to(dev)  # phase 5's batch shape
    for g, r in zip(cuda_extract.extract_sentinel(big, 28, 10, 2048),
                    cuda_extract.extract_sentinel_reference(big, 28, 10, 2048)):
        check(torch.equal(g, r), "kernel != plain at k=28 [4096, 4096]")
    kernel_ms = time_ms(lambda: cuda_extract.extract_sentinel(big, 28, 10, 2048), 50)
    plain_ms = time_ms(lambda: cuda_extract.extract_sentinel_reference(big, 28, 10, 2048), 10)
    del big
    gbytes = 4096 * 4096 * (1 + 8) / 1e9  # 1 B in, 2 words of 4 B out per position
    log(f"[kernel] [4096, 4096] k=28: kernel {kernel_ms:.4f} ms "
        f"({gbytes / kernel_ms * 1e3:.1f} GB/s), plain {plain_ms:.4f} ms")

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

        # --- 4b. mesh parity: cuda vs cpu vs the single device -------------
        mesh_out = {}
        for d in ("cuda", "cpu"):
            argv = ["28", "10", "3", "2048", "0", "0", fa, tmp + "/", "mesh_", "1", "0",
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
        check(same_bin_files(summary["output_dir"], single[28]),
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

    # --- 5. the CLI at real size --------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        genome = rng.integers(0, 4, size=GENOME, dtype=np.uint8)
        reads = sample_reads(rng, genome, COVERAGE * GENOME // READ_LEN, 0.001)
        fa = os.path.join(tmp, "reads.fa")
        write_reads_fasta(fa, reads)
        expect = valid_windows(reads, 28)
        n_bases = reads.size
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

        # --- 6. the mesh at real size: 4 shards, all on this card -------------
        argv6 = ["28", "10", "3", "2048", "0", "0", fa, tmp + "/", "mesh_", "1", "0", "1", "4",
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
        check(nb6 == n_batches, f"mesh made {nb6} batches, the single device {n_batches}")
        prepass = 4 * -(-nb6 // 100)  # 1-in-100 sampling (sample_fraction 0.01)
        check(full_launches >= 4 * nb6 + prepass,
              f"{full_launches} full-mode launches for {nb6} batches on 4 shards")
        check_mesh_run(s6, n_bases, expect, out5, "mesh")
        count6 = wall6 - s6["timings"].get("write_output", 0.0)
        log(f"[mesh real] {s6['n_unique']} distinct, {expect} instances, {nb6} batches, "
            f"{full_launches} full-mode launches; bin files == phase 5's")
        log(f"[mesh real] end to end {wall6:.2f} s = {n_bases / wall6 / 1e9:.4f} Gbp/s; "
            f"without write_output {n_bases / count6 / 1e9:.4f} Gbp/s (4 shards on one card)")
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

    # bounds: each input byte read once, each output byte written once
    rp = 4096 * (4096 - 28 + 1)
    kernels = [
        ("extract_count", "fastkmer_tpu/ops/pallas_extract.py:262 (extract_pallas_sentinel, "
         '_mk_kernel mode="count")', launches, max_err, kernel_ms, plain_ms,
         (4096 * 4096 + 2 * 4 * rp) / HBM_BYTES_PER_S * 1e3, None, "extract.cu"),
        ("extract_full", 'fastkmer_tpu/ops/pallas_extract.py:215 (extract_pallas, _mk_kernel '
         'mode="full")', stream_full, full_err, full_ms, full_plain_ms,
         (4096 * 4096 + 5 * 4 * rp) / HBM_BYTES_PER_S * 1e3, None, "extract.cu"),
        ("block_sort", "fastkmer_tpu/ops/pallas_sort.py:150 (sort_blocks, "
         "_mk_block_sort_kernel)", stream_sort, sort_err, sort_ms, sort_plain_ms,
         sort_bound_ms, sort_lib_ms, "block_sort.cu"),
    ]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"fastkmer_tpu_torch/csrc/{src}",
        "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": lib,
    } for name, replaces, n, err, ms, pms, bound, lib, src in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
