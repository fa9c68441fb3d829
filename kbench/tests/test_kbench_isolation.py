"""What the benchmark loads and reads: never JAX or the JAX package
(top-level module names compared whole; the port's name begins with the
JAX package's), and none of the repository's proof script, tools or
JAX-era probes."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from kbench import spec

BANNED = {"jax", "jaxlib", "flax", "fastkmer_tpu", "chip_smoke", "tools", "benchmarks"}

RUN_ONE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import kbench.run
from kbench import harness
from kbench.tests.tiny import tiny_cell
r = harness.run(tiny_cell("fastkmer_k28_text"), 9, 0.1, True, "cpu")
assert r["correct"], r
loaded = {m.split(".")[0] for m in sys.modules}
print(sorted(loaded & {"jax", "jaxlib", "flax", "fastkmer_tpu"}))
print("fastkmer_tpu_torch" in loaded)
"""


def test_a_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RUN_ONE, spec.ROOT], capture_output=True,
                         text=True, timeout=600, env=env, cwd=spec.KBENCH)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "True"]


def _sources():
    for d, _, files in os.walk(spec.KBENCH):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith(".py") and path != os.path.abspath(__file__):
                yield path


def test_sources_import_and_name_nothing_banned():
    for path in _sources():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                mods = []
            for m in mods:
                assert m.split(".")[0] not in BANNED, (path, m)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                for word in ("chip_smoke", "tools/", "benchmarks/"):
                    assert word not in node.value, (path, node.value)
