"""The text writer's metrics, ``text_group_s_per_gbp`` and
``text_bins_s_per_gbp``: their readers on a hand-built run, a traced run of
the tiny cells on the CPU, and the plain reference against the CLI where
runs of N fall across the k-1 overlaps of a long record's chunks."""

from __future__ import annotations

import functools

import pytest

from kbench import generate, harness, spec
from kbench.harness import Run
from kbench.tests.test_kbench_reference import SEED, _check, _run_cli
from kbench.tests.tiny import tiny_cell

TEXT = ("text_group_s_per_gbp", "text_bins_s_per_gbp")


def test_text_span_readers():
    timings = {"write_output": 4.0, "write_data": 3.0, "text_group": 0.75, "text_bins": 2.0}
    run = Run(None, [{"timings": timings}] * 2, 10**9)
    got = {n: spec.metric_reader(n)(run) for n in TEXT}
    assert got == {"text_group_s_per_gbp": 1.5, "text_bins_s_per_gbp": 4.0}
    # binary jobs, and the parent's text jobs, carry neither span
    old = Run(None, [{"timings": {"write_output": 4.0, "write_data": 3.0}}], 10**9)
    assert all(spec.metric_reader(n)(old) is None for n in TEXT)


@pytest.fixture
def accumulate(monkeypatch):
    from fastkmer_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "count_batches",
                        functools.partial(pipeline.count_batches, device_accumulate=True))


@pytest.mark.parametrize("config", ["fastkmer_k28_text", "kmc2_k55_bin"])
def test_traced_run_reports_the_text_writer_parts(config, accumulate, tmp_path):
    """The text cell reports both parts, each under the writer's data; the
    binary cell reports neither."""
    r = harness.run(tiny_cell(config), 2**31 + 5, 0.5, True, "cpu", tmp_root=str(tmp_path))
    assert r["correct"] and r["failed"] == 0
    if config == "fastkmer_k28_text":
        parts = [r["metrics"][n]["value"] for n in TEXT]
        assert all(v is not None and v > 0 for v in parts)
        assert sum(parts) <= r["metrics"]["write_data_s_per_gbp"]["value"]
    else:
        assert not set(TEXT) & set(r["metrics"])


def _gapped_overlaps(cell) -> int:
    """Chunk overlaps (the k-1 bases two chunks of a long record share)
    that hold an N, in the cell's input drawn from SEED."""
    job = spec.job_of(cell.config["argv"])
    n = (generate.rows(cell.traffic, SEED, "cpu") == 4).numpy()
    stride = job.read_len - (job.k - 1)
    return sum(int(row[s:s + job.k - 1].any()) for row in n
               for s in range(stride, row.size, stride))


def test_reference_agrees_with_cli_across_gaps(tmp_path):
    cell = tiny_cell("fastkmer_k28_text", n_rate=0.02)
    assert _gapped_overlaps(cell) >= 1
    job, out_dir, table, bins, cfg = _run_cli(cell, str(tmp_path))
    assert _check(out_dir, job, table, bins, cfg) == {"bytes_off": 0, "manifest_off": 0}
    assert table.words.shape[0] > 1000
