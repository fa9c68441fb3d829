"""Time and profile fastkmer_tpu_torch's count job on one CUDA card.

    python3 tools/profile_port.py [--reps 3] [--out build/profile]

Runs on chip_smoke.py's phase-5 workload (150-base reads at 16x coverage
of a 16,777,216-base random genome, k=28 m=10 x=3 B=2048, 4096 x 4096
batches, ``--unique-ub`` = genome length) and prints:

1. the extract kernel against its plain torch version at [4096, 4096] for
   k = 28, 31, 55, 97, 155: median milliseconds over CUDA events;
2. ``--reps`` runs of ``cli.main`` each with write=1 and write=0: wall
   seconds, Gbp/s, peak device memory and the stage spans;
3. one write=0 run under ``torch.profiler``: the summed time of the rows
   that run on the card (kernels, memcpy, memset; never the CPU op rows,
   which repeat their kernels' time), the union of those intervals over
   the wall (the device busy share), and the top device rows;
4. one write=0 run under the CUDA caching allocator's memory history: the
   peak of allocated bytes, the port's source line whose allocation set
   it, and the blocks live at that moment grouped by the port's source
   line that allocated them.

Every line it prints is also written to ``<out>/profile.log``; the
profiler table goes to ``<out>/key_averages.txt``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from fastkmer_tpu_torch import cli  # noqa: E402
from fastkmer_tpu_torch.ops import cuda_extract  # noqa: E402

KERNEL_CASES = ((28, 10), (31, 8), (55, 9), (97, 13), (155, 14))
HBM_GBPS = 3350.0  # H100 SXM5 HBM3 peak


def _port_frame(frames) -> str:
    """Innermost frame in the port's source as file:line function, then the
    next two port frames that called it (innermost first)."""
    port = [f for f in frames if "fastkmer_tpu_torch" in f.get("filename", "")]
    if not port:
        return "(outside the port)"
    fn = port[0]["filename"]
    where = f"{fn[fn.index('fastkmer_tpu_torch'):]}:{port[0]['line']} {port[0]['name']}"
    return " < ".join([where] + [f"{f['name']}:{f['line']}" for f in port[1:3]])


def memory_at_peak(snapshot: dict, top: int = 12):
    """Replay the allocator trace -> (peak bytes, frame of the allocation
    that set the peak, [(frame, bytes, blocks)] of the blocks live then)."""
    live: dict = {}
    total = peak = 0
    peak_live: dict = {}
    peak_frame = ""
    for ev in snapshot["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > peak:
                peak, peak_live, peak_frame = total, dict(live), _port_frame(ev["frames"])
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    groups: dict = collections.defaultdict(lambda: [0, 0])
    for ev in peak_live.values():
        g = groups[_port_frame(ev["frames"])]
        g[0] += ev["size"]
        g[1] += 1
    rows = sorted(((f, b, n) for f, (b, n) in groups.items()), key=lambda r: -r[1])
    return peak, peak_frame, rows[:top]


def device_rows(prof, wall_s: float) -> dict:
    """Device-side rows of a profile: summed times by kind and the union of
    their intervals as a share of ``wall_s``."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_kind = collections.Counter()
    spans = []
    for e in evs:
        kind = "memcpy" if e.name.startswith("Memcpy") else (
            "memset" if e.name.startswith("Memset") else "kernel")
        by_kind[kind] += e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return {
        "kernel_ms": by_kind["kernel"] / 1e3,
        "memcpy_ms": by_kind["memcpy"] / 1e3,
        "memset_ms": by_kind["memset"] / 1e3,
        "busy_union_ms": busy / 1e3,
        "busy_share": busy / 1e6 / wall_s,
        "n_rows": len(evs),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    logf = open(os.path.join(args.out, "profile.log"), "w")

    def log(msg: str) -> None:
        print(msg, flush=True)
        logf.write(msg + "\n")

    log(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cuda_extract.library()
    rng = np.random.default_rng(7)
    dev = torch.device("cuda", 0)

    big = torch.from_numpy(cs.random_codes(rng, 4096, 4096)).to(dev)
    for k, m in KERNEL_CASES:
        kms = cs.time_ms(lambda: cuda_extract.extract_sentinel(big, k, m, 2048), 30)
        pms = cs.time_ms(lambda: cuda_extract.extract_sentinel_reference(big, k, m, 2048), 5)
        W = -(-k // 16)
        gb = (4096 * 4096 + 4096 * (4096 - k + 1) * 4 * W) / 1e9  # 1 B in, 4*W B out
        log(f"KERNEL k={k} W={W}: {kms:.4f} ms ({gb / kms * 1e3:.1f} GB/s, "
            f"{gb / kms * 1e3 / HBM_GBPS * 100:.2f}% of {HBM_GBPS:.0f} GB/s); "
            f"plain {pms:.4f} ms")
    del big
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        genome = rng.integers(0, 4, size=cs.GENOME, dtype=np.uint8)
        reads = cs.sample_reads(rng, genome, cs.COVERAGE * cs.GENOME // cs.READ_LEN, 0.001)
        fa = os.path.join(tmp, "reads.fa")
        cs.write_reads_fasta(fa, reads)
        n_bases = reads.size
        del genome, reads
        stats = os.path.join(tmp, "stats.json")

        def run(write: str) -> float:
            argv = ["28", "10", "3", "2048", "0", "0", fa, tmp + "/", "real_", write, "0", "0",
                    "--device", "cuda", "--reads-per-batch", "4096", "--read-len", "4096",
                    "--unique-ub", str(cs.GENOME), "--stats-json", stats]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cs.check(cli.main(argv) == 0, "cli.main failed")
            return time.perf_counter() - t0

        for rep in range(args.reps):
            for write in ("1", "0"):
                wall = run(write)
                s = json.load(open(stats))
                log(f"RUN rep={rep} write={write} wall={wall:.4f} s "
                    f"gbps={n_bases / wall / 1e9:.5f} "
                    f"peak={torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                    f"timings={json.dumps(s['timings'])}")

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run("0")
        d = device_rows(prof, wall)
        log(f"PROFILED write=0 wall {wall:.4f} s; device rows: kernels "
            f"{d['kernel_ms']:.1f} ms, memcpy {d['memcpy_ms']:.1f} ms, memset "
            f"{d['memset_ms']:.1f} ms; busy (union) {d['busy_union_ms']:.1f} ms "
            f"= {d['busy_share'] * 100:.2f}% of the wall ({d['n_rows']} rows)")
        tab = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
        with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
            f.write(tab)
        log(tab[:5000])

        torch.cuda.memory._record_memory_history(
            enabled="all", context="alloc", stacks="python", max_entries=500_000)
        run("0")
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        peak, where, rows = memory_at_peak(snap)
        log(f"MEMORY peak {peak / 2**30:.3f} GiB allocated, set by {where}; "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for frame, nbytes, nblocks in rows:
            log(f"MEMORY live at peak: {nbytes / 2**30:8.3f} GiB in {nblocks:4d} blocks "
                f"from {frame}")
    logf.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
