"""Standalone runs of the port's bench modes and bench-layer probes on
one CUDA card, with the median of each number.

    python3 tools/measure_bench_layer.py [--reps 3] [--out build/bench_layer]

Each run is its own process, as a user would start it:

* ``python -m fastkmer_tpu_torch.bench <mode>`` for stream, step,
  percount, adaptive, forced and raw, and ``<mode> dup`` for stream,
  dedup, adaptive and forced (``dedup`` needs the dup workload: on the
  2^24 genome a batch's distinct rows overflow the npos / 4 compaction,
  and the mode raises, as bench.py's asserts);
* ``python -m fastkmer_tpu_torch.benchmarks.e2e`` (8 batches, fan-in 8,
  a 2^27-row table);
* ``mesh_dedup_probe --n 4`` at the bench's dup workload (2^21 genome);
* ``merge_probe`` (150,994,944 rows), ``stream_probe``, ``skew --mesh 8``;
* the probes of kernels A, B and C at the JAX probes' defaults:
  ``bigk_probe`` (k = 28-201 on [1024, 4096]), ``smer_pallas_probe``,
  ``pallas_sort_probe`` (2^24 rows, blocks of 2^15-2^17) and ``scaling``
  (64 reads of 1024 bases a shard), then ``scaling 1024 4096`` (at four
  shards one [4096, 4096] batch, the bench's batch shape).

``--reps`` rounds, each running every command once in the order above;
``--only`` keeps the commands named (``bench stream``, ``e2e``,
``scaling_4096``, ...; comma-separated).
The card's name and power limit (nvidia-smi) head the log; every JSON line
a run prints is kept, then the medians per measure are printed.  A run that
fails is reported with its stderr's tail and makes the exit code 1, after
the other runs.  Everything printed also goes to ``<out>/bench_layer.log``
and the raw lines to ``<out>/runs.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_MODES = ("stream", "step", "percount", "adaptive", "forced", "raw")
BENCH_DUP_MODES = ("stream", "dedup", "adaptive", "forced")
PROBES = {
    "e2e": ["-m", "fastkmer_tpu_torch.benchmarks.e2e", "8", "8", "27"],
    "mesh_dedup": ["-m", "fastkmer_tpu_torch.benchmarks.mesh_dedup_probe", "--n", "4"],
    "merge": ["-m", "fastkmer_tpu_torch.benchmarks.merge_probe"],
    "stream": ["-m", "fastkmer_tpu_torch.benchmarks.stream_probe"],
    "skew": ["-m", "fastkmer_tpu_torch.benchmarks.skew", "--mesh", "8"],
    "bigk": ["-m", "fastkmer_tpu_torch.benchmarks.bigk_probe"],
    "smer": ["-m", "fastkmer_tpu_torch.benchmarks.smer_pallas_probe"],
    "block_sort": ["-m", "fastkmer_tpu_torch.benchmarks.pallas_sort_probe"],
    "scaling": ["-m", "fastkmer_tpu_torch.benchmarks.scaling"],
    "scaling_4096": ["-m", "fastkmer_tpu_torch.benchmarks.scaling", "1024", "4096"],
}


def commands() -> list[tuple[str, list]]:
    return ([(f"bench {m}", ["-m", "fastkmer_tpu_torch.bench", m]) for m in BENCH_MODES]
            + [(f"bench {m} dup", ["-m", "fastkmer_tpu_torch.bench", m, "dup"])
               for m in BENCH_DUP_MODES]
            + list(PROBES.items()))


def numbers(name: str, recs: list) -> dict:
    """The numbers that PERF.md reads from a run's JSON lines, by command
    name (most commands' last line holds them all)."""
    rec = recs[-1]
    if name == "bigk":
        got = {}
        for r in recs:
            got.update({f"bigk.k{r['k']}.{r['arm']}.ms": r["ms"],
                        f"bigk.k{r['k']}.{r['arm']}.gbps": r["gbps"]})
            if r["arm"] == "kernel":
                got.update({f"bigk.k{r['k']}.kernel_ms": r["kernel_ms"],
                            f"bigk.k{r['k']}.bound_share": r["bound_share"]})
        return got
    if name == "smer":
        got = {f"smer.{r['arm']}.{f}": r[f] for r in recs[:-1] for f in ("ms", "gbps")}
        got["smer.speedup_kernel_over_plain"] = rec["speedup_kernel_over_plain"]
        return got
    if name == "block_sort":
        got = {}
        for r in recs[1:]:
            fields = (("marginal_ms", "naive_ms", "kernel_ms", "bound_share")
                      if r["measure"].startswith("block_sort") else ("marginal_ms", "ms"))
            got.update({f"{r['measure']}.{f}": r[f] for f in fields})
        return got
    if name.startswith("scaling"):
        return {f"{name}.n{r['mesh']}.{f}": r[f] for r in rec["summary"]
                for f in ("step_ms", "gbps", "exchange_bytes", "exchange_bytes_worstcase",
                          "scaling_efficiency") if f in r}
    if name.startswith("bench"):
        got = {rec["metric"]: rec["value"]}
        if "extra" in rec:
            got["bench.extra.step_gbps"] = rec["extra"]["step_gbps"]
        return got
    if name == "e2e":
        return {"e2e.gbps": rec["value"], "e2e.seconds": rec["seconds"]}
    if name == "mesh_dedup":
        got = {}
        for arm, a in rec["arms"].items():
            got.update({f"mesh_dedup.{arm}.time_s": a["time_s"], f"mesh_dedup.{arm}.gbps":
                        a["gbps"], f"mesh_dedup.{arm}.exchange_bytes": a["exchange_bytes"],
                        f"mesh_dedup.{arm}.n_dedup_batches": a["n_dedup_batches"]})
        return got
    if name == "merge":
        return {f"merge.{k}": v for k, v in rec.items() if k.endswith("_ms") or k in (
            "sort_share", "block_sort_vs_default")}
    if name == "stream":
        got = {"stream.put_s": rec["put_s"], "stream.land_s": rec["land_s"],
               "stream.extract_fenced_s": rec["extract_fenced_s"]}
        for i, r in enumerate(rec["reps"]):
            got.update({f"stream.rep{i}.feed_s": r["feed_s"], f"stream.rep{i}.fence_s":
                        r["fence_s"], f"stream.rep{i}.total_s": r["total_s"],
                        f"stream.rep{i}.dispatch_max_s": max(r["dispatch_s"]),
                        f"stream.rep{i}.dispatch_median_s": statistics.median(r["dispatch_s"])})
        return got
    if name == "skew":
        return {f"skew.{m}.{f}": rec[m][f] for m in ("hash", "lpt")
                for f in ("imbalance", "step_ms")}
    return {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=os.path.join(REPO, "build", "bench_layer"))
    p.add_argument("--only", default="", help="comma-separated command names to run")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    logf = open(os.path.join(args.out, "bench_layer.log"), "w")
    runs = open(os.path.join(args.out, "runs.jsonl"), "w")

    def say(msg: str) -> None:
        print(msg, flush=True)
        logf.write(msg + "\n")
        logf.flush()

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    say(f"card: {smi}")
    cmds = commands()
    if args.only:
        keep = args.only.split(",")
        unknown = set(keep) - {name for name, _ in cmds}
        if unknown:
            p.error(f"unknown commands {sorted(unknown)}")
        cmds = [(name, cmd) for name, cmd in cmds if name in keep]
    values: dict[str, list] = {}
    failed = 0
    t_all = time.perf_counter()
    for rep in range(args.reps):
        for name, cmd in cmds:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, *cmd], cwd=REPO, capture_output=True,
                                  text=True, timeout=1200)
            wall = time.perf_counter() - t0
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
            if proc.returncode != 0 or not lines:
                failed += 1
                say(f"FAILED rep {rep} {name} rc {proc.returncode} ({wall:.1f} s):\n"
                    f"{proc.stderr[-3000:]}")
                continue
            recs = [json.loads(ln) for ln in lines]
            runs.write(json.dumps({"rep": rep, "name": name, "wall_s": wall, "card": smi,
                                   "lines": recs}) + "\n")
            runs.flush()
            say(f"rep {rep} {name} ({wall:.1f} s): " + "\n  ".join(lines))
            for key, v in numbers(name, recs).items():
                values.setdefault(key, []).append(v)
    say(f"medians over {args.reps} standalone runs on {smi} "
        f"({time.perf_counter() - t_all:.1f} s in all):")
    for key, vs in values.items():
        say(f"  {key}: median {statistics.median(vs)!r} of {vs!r}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
