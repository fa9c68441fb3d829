"""BENCHMARK.json's names and files, the byte function of kernel A and the
idle-share arithmetic."""

from __future__ import annotations

import importlib
import os
import re

import pytest

from kbench import roofline, spec, trace
from kbench.harness import Run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_names_and_units():
    names = list(_names())
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        kind_names = [e["name"] for e in BENCH[kind]]
        assert len(kind_names) == len(set(kind_names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"job_gbps", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(name):
    cell = spec.cell(name)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.config["name"])
    assert os.path.isfile(os.path.join(spec.ROOT, entry["file"]))
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    assert cell.traffic["genome_bases"] > 0 and "{input}" in cell.config["argv"]
    assert cell.per_layer and any(m["name"] == "job_gbps" for m in cell.end_to_end)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    job = spec.job_of(cell.config["argv"])
    assert job.k == cell.config["k"] and job.binary == bool(cell.config["enableKryo"])


def test_every_moves_is_reported_by_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)


def test_kernel_a_bytes():
    assert roofline.extract_count_bytes(4096, 4096, 28) == (16_777_216, 133_332_992)
    # k = 55: four words; k = 32: two words and the flag lane
    assert roofline.extract_count_bytes(4096, 4096, 55)[1] == 4096 * 4042 * 4 * 4
    assert roofline.extract_count_bytes(1, 64, 32)[1] == 33 * 3 * 4


def _profile(device, host=(), job=(0.0, 100.0), wall=100e-6):
    return trace.Profile(wall, job, list(device), list(host))


def test_idle_share_union():
    p = _profile([(10, 30, "a"), (20, 40, "b"), (50, 60, "a"), (55, 58, "c")],
                 host=[(0, 100, "outer"), (40, 45, "aten::copy_"), (60, 100, "cudaFree")])
    assert trace.merged(p.device) == [[10, 40], [50, 60]]
    assert trace.busy_seconds(p) == pytest.approx(40e-6)
    read = importlib.import_module("kbench.metrics.device_idle_pct").read
    assert read(Run(None, [], 0, p)) == pytest.approx(60.0)
    # longest first; of two equal gaps, the later first
    assert trace.idle_gaps(p) == [["cudaFree", pytest.approx(40e-6)],
                                  ["aten::copy_", pytest.approx(10e-6)],
                                  ["outer", pytest.approx(10e-6)]]
    assert trace.top_device_ops(p)[0] == ["a", pytest.approx(30e-6)]
    assert read(Run(None, [], 0, None)) is None


def test_roofline_reader():
    job = spec.job_of(spec.config("fastkmer_k28_text")["argv"])
    bytes_in, bytes_out = roofline.extract_count_bytes(4096, 4096, 28)
    us = roofline.least_seconds(bytes_in + bytes_out) * 1e6 * 2  # half the bound
    name = ("void (anonymous namespace)::extract_count_kernel<2048>(unsigned char const*, "
            "long, long, long, int, int, int, int*, long)")
    p = _profile([(0, us, name), (us, 2 * us, name), (0, 5, "extract_full_kernel(...)")])
    read = importlib.import_module("kbench.metrics.kernel_a_roofline").read
    assert read(Run(job, [], 0, p)) == pytest.approx(50.0)
    assert read(Run(job, [], 0, _profile([(0, 5, "other")]))) is None


def test_span_readers():
    jobs = [{"timings": {"ingest_wait": 1.0, "device_count": 0.5, "device_merge": 0.25,
                         "merge": 2.0, "write_output": 4.0}, "n_bases": 5 * 10**8}] * 2
    run = Run(None, jobs, 10**9)
    got = {n: spec.metric_reader(n)(run) for n in (
        "ingest_wait_s_per_gbp", "device_count_s_per_gbp", "finalize_s_per_gbp",
        "write_s_per_gbp")}
    assert got == {"ingest_wait_s_per_gbp": 2.0, "device_count_s_per_gbp": 1.5,
                   "finalize_s_per_gbp": 4.0, "write_s_per_gbp": 8.0}
