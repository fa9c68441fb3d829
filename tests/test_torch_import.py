"""fastkmer_tpu_torch imports neither jax nor the JAX package fastkmer_tpu.

A fresh interpreter (this test process has jax loaded by conftest)
imports every module of the port, counts a 2-read FASTA on the CPU on one
device, on a 2-shard per-batch mesh and on a 2-shard streaming mesh, and
finds no jax, jaxlib, triton, fastkmer_tpu, fastkmer_tpu.* or root
benchmarks module.  A second check reads the sources: no module of the port
and not chip_smoke.py names fastkmer_tpu, jax or the root benchmarks package
in an import (the port's own probes are fastkmer_tpu_torch.benchmarks)."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import fastkmer_tpu_torch
from fastkmer_tpu_torch import api, cli, config, debug, pipeline
from fastkmer_tpu_torch.core import bits, tbits
from fastkmer_tpu_torch.ingest import batch, fasta, native, prefetch
from fastkmer_tpu_torch.ops import (binhash, count_sort, cuda_extract, cuda_sort, extract,
                                    superkmer, windows)
from fastkmer_tpu_torch.output import manifest, writer
from fastkmer_tpu_torch.output import native as out_native
from fastkmer_tpu_torch.parallel import driver, exchange, partitioner, stream
from fastkmer_tpu_torch.utils import cudabuild, nativebuild, timing
from fastkmer_tpu_torch.benchmarks import (compact_probe, cuda_bitonic_merge, cuda_probe,
                                           primitives, resume_merge_probe, roofline,
                                           split_merge_probe)

fa = sys.argv[1]
with open(fa, "w") as f:
    f.write(">a\nACGTACGTTTGACCANGGTACGATCGATCGGATCCA\n>b\nTTTTTTTTTTTTTTTTTTTTTTTTTTTT\n")
res = api.count_kmers(fa, k=13, m=5, bins=16, device="cpu")
assert res.n_instances == 3 + 8 + 16, res.n_instances
for streaming in (False, True):
    mesh = api.count_kmers_distributed(fa, n_devices=2, k=13, m=5, bins=16, device="cpu",
                                       streaming=streaming, reads_per_batch=4, read_len=64)
    assert mesh.n_instances == res.n_instances, (streaming, mesh.n_instances)
    assert (mesh.words == res.words).all() and (mesh.counts == res.counts).all()
parts = [(res.words[:2], res.counts[:2], res.bins[:2]), (res.words[1:], res.counts[1:], res.bins[1:])]
merged = pipeline.merge_partials(parts, 1)
assert merged[0].shape[0] == res.words.shape[0]
assert cuda_extract.LAUNCHES == cuda_extract.FULL_LAUNCHES == cuda_sort.LAUNCHES == 0
assert cuda_bitonic_merge.LAUNCHES == cuda_probe.COPY_LAUNCHES == cuda_probe.TRANSPOSE_LAUNCHES == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "fastkmer_tpu", "benchmarks"))
assert not bad, bad
print("OK", res.n_instances, len(res.counts))
"""

_IMPORT = re.compile(r"^\s*(?:from\s+(\S+)\s+import|import\s+(\S+))", re.M)


def test_port_imports_no_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "two.fa")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_port_sources_name_no_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "fastkmer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            for mod in _IMPORT.findall(f.read()):
                name = (mod[0] or mod[1]).split(".")[0].rstrip(",")
                if name in ("fastkmer_tpu", "jax", "jaxlib", "benchmarks"):
                    bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad
