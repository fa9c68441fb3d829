"""fastkmer_tpu_torch imports neither jax nor the JAX package fastkmer_tpu.

A fresh interpreter (this test process has jax loaded by conftest)
imports every module of the port, counts a 2-read FASTA on the CPU on one
device, on a 2-shard per-batch mesh and on a 2-shard streaming mesh, and
with the HT engine on one device and the mesh, runs multiseq on one device
and on the streaming mesh, and
finds no jax, jaxlib, triton, fastkmer_tpu, fastkmer_tpu.* or root
benchmarks, bench or __graft_entry__ module.  A second check reads the
sources: no module of the port and not chip_smoke.py names fastkmer_tpu,
jax or those root modules in an import (the port's own probes are
fastkmer_tpu_torch.benchmarks, its bench and entry points
fastkmer_tpu_torch.bench and .entry)."""

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
from fastkmer_tpu_torch import api, bench, cli, config, debug, entry, pipeline
from fastkmer_tpu_torch.core import bits, tbits
from fastkmer_tpu_torch.ingest import batch, fasta, native, prefetch
from fastkmer_tpu_torch.multiseq import distances as ms_distances
from fastkmer_tpu_torch.multiseq import distributed as ms_distributed
from fastkmer_tpu_torch.multiseq import pipeline as ms_pipeline
from fastkmer_tpu_torch.ops import (binhash, count_hash, count_sort, cuda_extract, cuda_sort,
                                    extract, superkmer, windows)
from fastkmer_tpu_torch.output import manifest, writer
from fastkmer_tpu_torch.output import native as out_native
from fastkmer_tpu_torch.parallel import driver, exchange, partitioner, stream
from fastkmer_tpu_torch.utils import cudabuild, nativebuild, timing
from fastkmer_tpu_torch.benchmarks import (bigk_probe, compact_probe, cuda_bitonic_merge,
                                           cuda_probe, distance_probe, e2e, e2e_file,
                                           ht_vs_sort, merge_probe, mesh_dedup_probe,
                                           multiseq_probe, pallas_sort_probe, primitives,
                                           resume_merge_probe, roofline, scaling, skew,
                                           smer_pallas_probe, split_merge_probe, stream_probe)

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
for ht in (api.count_kmers(fa, k=13, m=5, bins=16, device="cpu", use_ht=True),
           api.count_kmers_distributed(fa, n_devices=2, k=13, m=5, bins=16, device="cpu",
                                       use_ht=True, reads_per_batch=4, read_len=64)):
    assert (ht.words == res.words).all() and (ht.counts == res.counts).all()
ms_cfg = ms_pipeline.MultiseqConfig(dataset=fa, output_directory="", k=13, m=5, max_b=16,
                                    write=False, reads_per_batch=4, read_len=64,
                                    distance_measure="kld_log2")
ms = ms_pipeline.execute_multiseq_job(ms_cfg, verbose=False, device="cpu")
assert ms.sequence_names == ["a", "b"] and ms.n_instances == res.n_instances, ms
ms_mesh = ms_distributed.execute_multiseq_job_distributed(ms_cfg, exchange.make_mesh(2, "cpu"),
                                                          verbose=False)
assert (ms_mesh.words == ms.words).all() and ms_mesh.distances == ms.distances
parts = [(res.words[:2], res.counts[:2], res.bins[:2]), (res.words[1:], res.counts[1:], res.bins[1:])]
merged = pipeline.merge_partials(parts, 1)
assert merged[0].shape[0] == res.words.shape[0]
assert cuda_extract.LAUNCHES == cuda_extract.FULL_LAUNCHES == cuda_sort.LAUNCHES == 0
assert cuda_bitonic_merge.LAUNCHES == cuda_probe.COPY_LAUNCHES == cuda_probe.TRANSPOSE_LAUNCHES == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "fastkmer_tpu", "benchmarks",
                                    "bench", "__graft_entry__"))
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
                if name in ("fastkmer_tpu", "jax", "jaxlib", "benchmarks", "bench",
                            "__graft_entry__"):
                    bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad
