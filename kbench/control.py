"""The control of a cell's comparison: the reference in the program's place,
with one guarantee broken, must come out not correct.

The configurations state exact keys.  The control counts the cell's input
keyed by a 31-bit fingerprint of each canonical k-mer (kbench.reference.
count_fingerprinted), the narrower key that would tempt a faster counter,
writes its table as the job would, holds that directory to the exact
reference with the run's own comparison, and judges it by the run's own
limits (kbench.harness.is_correct).  One JSON line a seed, with
``correct``.

    python3 kbench/control.py --workload <cell> --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def control_checks(cell, seed: int, device: str, tmp: str) -> dict:
    """The comparison's numbers for the control's output of one seed, and
    the distinct k-mers on either side."""
    from kbench import compare, generate, reference, spec

    job = spec.job_of(cell.config["argv"])
    codes = generate.rows(cell.traffic, seed, device)
    exact = reference.count(codes, job.k)
    fp = reference.count_fingerprinted(codes, job.k)
    del codes
    out = os.path.join(tmp, "out") + os.sep
    out_dir = job.output_dir(out)
    config = compare.expected_config(job, os.path.join(tmp, "reads.fa"), out)
    reference.write_output(out_dir, job, fp.words, fp.counts,
                           reference.bins(fp.words, job.k, job.m, job.b), config)
    checks = compare.check_output(compare.snapshot(out_dir), job, exact.words, exact.counts,
                                  reference.bins(exact.words, job.k, job.m, job.b), config)
    shutil.rmtree(out_dir)
    checks["jobs_off"] = 0  # one output: nothing to hold it to
    checks["distinct_exact"] = int(exact.words.shape[0])
    checks["distinct_control"] = int(fp.words.shape[0])
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from kbench import harness, spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        tmp = tempfile.mkdtemp(prefix="kbench-control-")
        try:
            t0 = time.perf_counter()
            checks = control_checks(cell, seed, "cuda", tmp)
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct":
                          harness.is_correct(checks), "seconds": time.perf_counter() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
