"""Entry point of the benchmark: one run of one cell of BENCHMARK.json.

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It prints one JSON line last on standard
output, and each compared number beside its limit as the last lines of
standard error.  The kernel caches of the program and of the libraries it
may load are kept at fixed paths under the checkout's ``build/``.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from kbench import harness

    sys.exit(harness.main())
