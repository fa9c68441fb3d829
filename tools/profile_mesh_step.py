"""Split the per-batch mesh step's time by stage on one CUDA card.

    python3 tools/profile_mesh_step.py [--out build/mesh_step]

Cases: the ``scaling`` probe's step (``benchmarks/scaling.prepare``, k = 28,
m = 10, B = 512, hash owners, the sized cap) at one shard of 64 reads x 1024
bases, one shard of 1024 x 4096 and four shards of 1024 x 4096 (one
[4096, 4096] batch); then ``smer_pallas_probe``'s kernel arm (the public
super-k-mer step, one shard of 512 x 4096).  For each case, after a warm
step:

1. ``step_ms``: the mean of STEPS steps, fenced at the end only, as the
   probe times them;
2. the fenced split: each stage function is wrapped to synchronize the card
   before and after it, and its host-clock ms a step are summed; ``other``
   is the fenced step less its stages (the routing glue, the sums);
3. STEPS steps under ``torch.profiler``, each stage a ``record_function``
   span: per stage its host ms and its device range (first kernel's start
   to last kernel's end) a step; the card's kernel and copy ms a step and
   the union of its rows as a share of the profiled wall
   (``profile_port.device_rows``, the spans' ranges left out; the
   profiler's own cost lengthens that wall); kernel launches and host
   synchronizations a step; the top rows by host self time and by device
   time (in ``<out>/mesh_step_tables.txt``).

The stages: ``extract`` (``cuda_extract.extract_full``, kernel B),
``group`` (``superkmer.group``), ``route`` (``exchange.route_by_owner``),
``exchange`` (``exchange._exchange``), ``expand`` (``superkmer.expand``),
``count_sort`` (``count_sort.count_sorted``) and ``bins``
(``binhash.bins_from_words``).  Every line printed also goes to
``<out>/mesh_step.log``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fastkmer_tpu_torch.benchmarks import scaling, smer_pallas_probe  # noqa: E402
from fastkmer_tpu_torch.ops import binhash, count_sort, cuda_extract, superkmer  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange, partitioner  # noqa: E402
from profile_port import device_rows  # noqa: E402

STEPS = 5
STAGES = (
    ("extract", cuda_extract, "extract_full"),
    ("group", superkmer, "group"),
    ("route", exchange, "route_by_owner"),
    ("exchange", exchange, "_exchange"),
    ("expand", superkmer, "expand"),
    ("count_sort", count_sort, "count_sorted"),
    ("bins", binhash, "bins_from_words"),
)
MODE = ["off"]  # "off", "fence" or "span"
FENCED = collections.Counter()


def _wrap(stage: str, mod, attr: str) -> None:
    fn = getattr(mod, attr)

    def staged(*a, **kw):
        if MODE[0] == "fence":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            FENCED[stage] += time.perf_counter() - t0
            return out
        if MODE[0] == "span":
            with record_function(f"stage:{stage}"):
                return fn(*a, **kw)
        return fn(*a, **kw)

    setattr(mod, attr, staged)


def _steps(step, sharded) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(sharded)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEPS * 1e3


def cases(dev: torch.device):
    """(name, step, sharded batch, windows a step) of each case, built lazily."""
    for n, rpc, L in ((1, 64, 1024), (1, 1024, 4096), (4, 1024, 4096)):
        step, sharded, _, _, _ = scaling.prepare(n, rpc, L, np.random.default_rng(0), dev)
        yield f"scaling n={n} {rpc}x{L}", step, sharded, n * rpc * (L - scaling.K + 1)
    p = smer_pallas_probe
    mesh = exchange.make_mesh(1, dev)
    codes = p.make_reads(np.random.default_rng(0), p.R, p.L)
    cap = p.R * (p.L - p.K + 1) // 3
    step = exchange.build_distributed_count_smer(mesh, p.K, p.M, p.B, cap, p.SMAX,
                                                 partitioner.hash_owner_map(p.B, 1))
    yield f"smer kernel n=1 {p.R}x{p.L}", step, exchange.shard_batch(mesh, codes), \
        p.R * (p.L - p.K + 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "mesh_step"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mesh_step: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    logf = open(os.path.join(args.out, "mesh_step.log"), "w")
    tabf = open(os.path.join(args.out, "mesh_step_tables.txt"), "w")

    def log(msg: str) -> None:
        print(msg, flush=True)
        logf.write(msg + "\n")

    log(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    for stage, mod, attr in STAGES:
        _wrap(stage, mod, attr)
    dev = torch.device("cuda", 0)
    for name, step, sharded, windows in cases(dev):
        step(sharded)  # warm-up
        step_ms = _steps(step, sharded)
        MODE[0] = "fence"
        FENCED.clear()
        fenced_ms = _steps(step, sharded)
        split = {s: FENCED[s] / STEPS * 1e3 for s, _, _ in STAGES if s in FENCED}
        split["other"] = fenced_ms - sum(split.values())
        MODE[0] = "span"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_ms = _steps(step, sharded)
        MODE[0] = "off"
        evs = prof.events()
        host, device = collections.Counter(), collections.Counter()
        for e in evs:
            if e.name.startswith("stage:"):
                on_card = e.device_type == DeviceType.CUDA
                (device if on_card else host)[e.name[6:]] += (
                    e.time_range.elapsed_us() if on_card else e.cpu_time_total) / 1e3 / STEPS
        d = device_rows(prof, wall_ms * STEPS / 1e3, spans="stage:")
        log(json.dumps({
            "case": name, "windows": windows, "step_ms": step_ms, "fenced_ms": fenced_ms,
            "fenced_split_ms": split, "profiled_ms": wall_ms,
            "span_host_ms": host, "span_device_ms": device,
            "kernel_ms": d["kernel_ms"] / STEPS, "memcpy_ms": d["memcpy_ms"] / STEPS,
            "busy_share": d["busy_share"],
            "launches": sum("LaunchKernel" in e.name for e in evs) / STEPS,
            "syncs": sum("Synchronize" in e.name for e in evs) / STEPS,
        }))
        for key in ("self_cpu_time_total", "self_cuda_time_total"):
            tabf.write(f"== {name}: by {key}, {STEPS} steps\n")
            tabf.write(prof.key_averages().table(sort_by=key, row_limit=25) + "\n")
        del step, sharded, prof
        torch.cuda.empty_cache()
    logf.close()
    tabf.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
