"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell's
configuration lives in ``kbench/configs/<config>.json``, its traffic in
``kbench/traffic/<traffic>.json`` and each per-layer metric's reader in
``kbench/metrics/<metric>.py``.  A new cell, configuration, mix or metric
is a new file and a new entry, never an edit of this module.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

KBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(KBENCH)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def load_benchmark(path: str = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_json(kind: str, name: str) -> dict:
    with open(os.path.join(KBENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _load_json("configs", name)


def traffic(name: str) -> dict:
    return _load_json("traffic", name)


def metric_reader(name: str):
    """The ``read(run)`` function of ``kbench/metrics/<name>.py``."""
    return importlib.import_module(f"kbench.metrics.{name}").read


@dataclasses.dataclass(frozen=True)
class Job:
    """The count job a configuration's argv describes (the CLI's
    positionals: k m x B useHT sequenceType input output prefix write
    enableKryo useCustomPartitioner, then its flags)."""

    k: int
    m: int
    x: int
    max_b: int
    use_ht: bool
    sequence_type: int
    prefix: str
    write: bool
    binary: bool
    reads_per_batch: int
    read_len: int

    @property
    def b(self) -> int:
        return min(4**self.m, self.max_b)

    def output_dir(self, output: str) -> str:
        """Where the CLI writes: <output><prefix>k<k>_m<m>_x<x>_b<b>_s<type>."""
        return (f"{output}{self.prefix}k{self.k}_m{self.m}_x{self.x}_b{self.b}"
                f"_s{self.sequence_type}")


def _flag(argv: list, name: str, default: int) -> int:
    return int(argv[argv.index(name) + 1]) if name in argv else default


def job_of(argv: list) -> Job:
    k = int(argv[0])
    return Job(
        k=k, m=int(argv[1]), x=int(argv[2]), max_b=int(argv[3]), use_ht=argv[4] == "1",
        sequence_type=int(argv[5]), prefix=argv[8], write=argv[9] == "1",
        binary=argv[10] == "1",
        reads_per_batch=_flag(argv, "--reads-per-batch", 512),
        # the job raises a row shorter than 2k to 2k (JobConfig.__post_init__)
        read_len=max(_flag(argv, "--read-len", 4096), 2 * k),
    )


def fill_argv(template: list, **values) -> list:
    """The configuration's argv with {input}, {output} and the traffic's
    numbers (such as {genome_bases}) filled in."""
    return [a.format(**values) for a in template]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell named ``name`` in BENCHMARK.json, with its configuration,
    its traffic and the metrics it reports."""
    bench = bench or load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def ours(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=int(entry["chips"]), config=config(entry["config"]),
        traffic=traffic(entry["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if ours(m)],
        per_layer=[m for m in bench["per_layer"] if ours(m)],
    )
