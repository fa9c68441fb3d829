"""A whole run on the CPU (the harness's look for a card skipped), sound and
with the timed path broken underneath: each fault must read not correct.

On the CPU the count job takes its host path unless told to accumulate;
the runs here force the accumulator, the path every cell takes on the
card.  Faults: a merge that returns its state unchanged, half of each
batch's windows left out, one count altered where the table is produced.
One chip: there is no exchange to leave out.
"""

from __future__ import annotations

import functools

import pytest
import torch

from kbench import harness
from kbench.tests.tiny import tiny_cell

CONFIGS = ["fastkmer_k28_text", "kmc2_k55_bin"]


@pytest.fixture
def accumulate(monkeypatch):
    from fastkmer_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "count_batches",
                        functools.partial(pipeline.count_batches, device_accumulate=True))
    return pipeline


def _run(config, tmp_path, traced=False):
    return harness.run(tiny_cell(config), 2**31 + 5, 0.5, traced, "cpu",
                       tmp_root=str(tmp_path))


@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_is_correct(config, accumulate, tmp_path):
    r = _run(config, tmp_path, traced=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert {"ingest_wait_s_per_gbp", "device_count_s_per_gbp", "finalize_s_per_gbp",
            "write_s_per_gbp"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _stale_state(monkeypatch, pipeline):
    def merge(parts, acc, block_sort=False):
        parts.clear()
        return acc

    monkeypatch.setattr(pipeline, "_acc_merge", merge)


def _half_batch(monkeypatch, pipeline):
    from fastkmer_tpu_torch.ops import cuda_extract

    orig = cuda_extract.extract_sentinel

    def half(*a, **kw):
        cols = orig(*a, **kw)
        n = cols[0].shape[0] // 2
        return tuple(torch.cat([c[:n], torch.full_like(c[n:], -1)]) for c in cols)

    monkeypatch.setattr(cuda_extract, "extract_sentinel", half)


def _altered_count(monkeypatch, pipeline):
    orig = pipeline.DeviceAccumulator.finalize

    def finalize(self):
        words, counts, bins = orig(self)
        counts = counts.copy()
        counts[len(counts) // 2] += 1
        return words, counts, bins

    monkeypatch.setattr(pipeline.DeviceAccumulator, "finalize", finalize)


@pytest.mark.parametrize("fault", [_stale_state, _half_batch, _altered_count],
                         ids=["stale_state", "half_batch", "altered_count"])
@pytest.mark.parametrize("config", CONFIGS)
def test_fault_is_not_correct(config, fault, accumulate, monkeypatch, tmp_path):
    fault(monkeypatch, accumulate)
    r = _run(config, tmp_path)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
