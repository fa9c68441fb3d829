"""One run of one cell: generate, warm up, time whole count jobs, check.

1. The cell's input is drawn from ``--seed`` on the card and written as
   FASTA into a fresh directory under ``TMPDIR``.
2. One warm-up job runs the cell's argv on the file's first rows, about
   ``WARM_BASES`` bases, one batch of the cell's shape; with the process's
   start-up and the generation it is ``setup_s``.
3. ``fastkmer_tpu_torch.cli.main`` jobs on the whole file run back to back
   in this process for about ``--seconds``: the window closes after the
   job whose end lies nearest to it.  Each job ends once its output is on
   disk (``os.sync``), as a user's job must before the output is used.
   Between two jobs the harness only renames the output directory away
   (deleting 2,000 files took it 0.8-2 s on the card's host, varying more
   than the jobs did); the outputs are read and deleted once the window
   has closed.  One job, drawn from the seed among the first
   ``KEEP_AMONG`` (the last, if the window ends before it), is held to the
   reference.  No job starts once one more would take the run's written
   bytes past ``WRITE_CAP``.
4. With ``--trace 1`` one more job runs under ``torch.profiler``.
5. The plain reference (``kbench.reference``) counts the same input on the
   card, and ``kbench.compare`` holds the kept job's output to it; every
   other job's manifest, which carries the sha256 of each of its files,
   must equal the kept job's byte for byte.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import random
import shutil
import sys
import tempfile
import time

from . import compare, generate, reference, spec, trace

WRITE_CAP = 4 << 30  # bytes a run may write, its input included
# the warm-up's cut of the input: one batch of the cell's own [R, L] shape
# (the last batch of a job is padded to it too), with few enough k-mers
# that the warm-up's writing stays short
WARM_BASES = 1 << 20
KEEP_AMONG = 3  # the checked job is drawn from the window's first three
FORBIDDEN = ("jax", "jaxlib", "flax", "fastkmer_tpu")
LIMITS = {"bytes_off": 0, "manifest_off": 0, "jobs_off": 0}  # exact or wrong


def process_age() -> float | None:
    """Seconds since this process started (Linux /proc, 10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Run:
    """What the per-layer readers see."""

    job: spec.Job
    jobs: list  # the window's --stats-json summaries
    bases: int  # bases the window's jobs counted
    profile: trace.Profile | None = None


def is_correct(checks: dict) -> bool:
    """Every compared number within its limit."""
    return all(checks[n] <= LIMITS[n] for n in LIMITS)


def log(msg: str) -> None:
    print(f"kbench: {msg}", file=sys.stderr, flush=True)


def _dir_bytes(path: str) -> int:
    return sum(e.stat().st_size for e in os.scandir(path) if e.is_file()) \
        if os.path.isdir(path) else 0


class Jobs:
    """Runs the cell's count job through the CLI, in this process."""

    def __init__(self, argv: list, stats: str):
        from fastkmer_tpu_torch import cli

        self.main = cli.main
        self.argv = argv + ["--stats-json", stats]
        self.stats = stats

    def __call__(self) -> dict:
        t0, c0 = time.perf_counter(), os.times()
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            rc = self.main(self.argv)
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc}")
        with open(self.stats) as f:
            summary = json.load(f)
        summary["wall_s"] = time.perf_counter() - t0
        c1 = os.times()
        # the process's CPU seconds in the job, user and system (its file
        # writes): what a slow job spent its time on (logged, not reported)
        summary["user_s"] = c1.user - c0.user
        summary["sys_s"] = c1.system - c0.system
        return summary


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
        tmp_root: str | None = None) -> dict:
    """One run -> the result line's fields (without the import check)."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    tmp = tempfile.mkdtemp(prefix="kbench-", dir=tmp_root)
    try:
        return _run(cell, cfg, traffic, seed, seconds, traced, device, tmp, torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, cfg, traffic, seed, seconds, traced, device, tmp, torch) -> dict:
    t_start = time.perf_counter()
    log(f"process age {process_age()} s at the run's start")
    cuda = device == "cuda"
    # 1. the input, drawn on the card, and its FASTA
    codes = generate.rows(traffic, seed, device)
    records = generate.fasta_bytes(codes, traffic["line_width"]).cpu().numpy()
    host_codes = codes.cpu()
    del codes
    fa, warm_fa = os.path.join(tmp, "reads.fa"), os.path.join(tmp, "warm.fa")
    written = generate.write_fasta(fa, records)
    job = spec.job_of(cfg["argv"])
    n_rows, row_len = host_codes.shape
    written += generate.write_fasta(warm_fa, records[:max(1, WARM_BASES // row_len)])
    del records
    if cuda:
        torch.cuda.empty_cache()
    log(f"generated {n_rows} rows of {row_len} bases, {written} bytes of FASTA, "
        f"{time.perf_counter() - t_start:.3f} s")

    def argv(inp: str, out: str) -> list:
        return spec.fill_argv(cfg["argv"], input=inp, output=out, **traffic) + [
            "--device", device]

    # 2. the warm-up job on one batch
    warm_out = os.path.join(tmp, "warm") + os.sep
    Jobs(argv(warm_fa, warm_out), os.path.join(tmp, "warm.json"))()
    written += _dir_bytes(job.output_dir(warm_out))
    shutil.rmtree(warm_out, ignore_errors=True)
    log(f"warm-up job done, {time.perf_counter() - t_start:.3f} s")
    out = os.path.join(tmp, "out") + os.sep
    out_dir = job.output_dir(out)
    run_job = Jobs(argv(fa, out), os.path.join(tmp, "stats.json"))
    os.sync()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    age = process_age()
    setup_s = age if age is not None else time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s")

    # 3. the window
    keep = random.Random(seed).randrange(KEEP_AMONG)
    jobs, done, failed, job_bytes = [], [], 0, 0
    t_first = time.perf_counter()
    t_end = t_first
    while True:
        t0 = time.perf_counter()
        try:
            summary = run_job()
            os.sync()
        except Exception as e:  # a job that fails is counted, and ends the window
            log(f"job {len(jobs)} failed: {type(e).__name__}: {e}")
            failed += 1
            break
        t_end = time.perf_counter()
        jobs.append(summary)
        done.append(os.path.join(tmp, f"done{len(done)}"))
        os.rename(out_dir, done[-1])
        job_bytes = job_bytes or _dir_bytes(done[0])
        written += job_bytes
        if t_end - t_first + (t_end - t0) / 2 > seconds or written + job_bytes > WRITE_CAP:
            break
    window_s = t_end - t_first
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bases = len(jobs) * n_rows * row_len
    data = Run(job, jobs, bases)
    for i, j in enumerate(jobs):
        spans = " ".join(f"{k}={v:.3f}" for k, v in sorted(j["timings"].items()))
        log(f"job {i}: {j['wall_s']:.3f} s; {spans}; "
            f"cpu user {j['user_s']:.2f} s, system {j['sys_s']:.2f} s")
    kept_index = min(keep, len(done) - 1)
    kept = compare.snapshot(done[kept_index]) if done else {}
    manifests = [_read(os.path.join(d, "manifest.json")) for d in done]
    for d in done:
        shutil.rmtree(d, ignore_errors=True)

    # 4. the traced job
    extra = []
    if traced and not failed:
        try:
            data.profile = trace.profile_job(lambda: (extra.append(run_job()), os.sync()))
            manifests.append(_read(os.path.join(out_dir, "manifest.json")))
        except Exception as e:
            log(f"traced job failed: {type(e).__name__}: {e}")
            failed += 1
        shutil.rmtree(out_dir, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()

    # 5. the reference and the checks
    t_check = time.perf_counter()
    checks = dict.fromkeys(LIMITS, 0)
    if kept:
        codes = host_codes.to(device)
        table = reference.count(codes, job.k)
        del codes
        ref_bins = reference.bins(table.words, job.k, job.m, job.b)
        config = compare.expected_config(job, fa, out)
        checks.update(compare.check_output(kept, job, table.words, table.counts,
                                           ref_bins, config))
        checks["jobs_off"] = sum(m != manifests[kept_index] for m in manifests)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct = bool(kept) and not failed and is_correct(checks)

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"job_gbps": bases / 1e9 / window_s if jobs else None, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": len(jobs) + len(extra) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if data.profile is not None:
        dev["busy_s"] = trace.busy_seconds(data.profile)
        dev["window_s"] = data.profile.wall_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(data.profile),
                               "idle_gaps": trace.idle_gaps(data.profile)}
    log(f"window {window_s:.3f} s, {len(jobs)} jobs, {bases} bases")
    result["checks"] = {n: {"value": int(checks[n]), "limit": LIMITS[n]} for n in LIMITS}
    return result


def _read(path: str) -> bytes | None:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
