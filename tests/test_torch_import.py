"""fastkmer_tpu_torch imports no jax: a fresh interpreter (this test
process has jax loaded by conftest) imports every slice module, counts a
2-read FASTA on the CPU on one device and on a 2-shard mesh, and finds no
jax, jaxlib or triton module."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import fastkmer_tpu_torch
from fastkmer_tpu_torch import api, cli, debug, pipeline
from fastkmer_tpu_torch.core import tbits
from fastkmer_tpu_torch.ops import (binhash, count_sort, cuda_extract, extract,
                                    superkmer, windows)
from fastkmer_tpu_torch.parallel import driver, exchange
from fastkmer_tpu_torch.utils import cudabuild

fa = sys.argv[1]
with open(fa, "w") as f:
    f.write(">a\nACGTACGTTTGACCANGGTACGATCGATCGGATCCA\n>b\nTTTTTTTTTTTTTTTTTTTTTTTTTTTT\n")
res = api.count_kmers(fa, k=13, m=5, bins=16, device="cpu")
assert res.n_instances == 3 + 8 + 16, res.n_instances
mesh = api.count_kmers_distributed(fa, n_devices=2, k=13, m=5, bins=16, device="cpu",
                                   streaming=False, reads_per_batch=4, read_len=64)
assert mesh.n_instances == res.n_instances, mesh.n_instances
assert cuda_extract.LAUNCHES == cuda_extract.FULL_LAUNCHES == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not bad, bad
print("OK", res.n_instances, len(res.counts))
"""


def test_port_imports_no_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "two.fa")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
