"""On the card: a small run through the card's path, with its trace."""

from __future__ import annotations

import pytest

from kbench import harness
from kbench.tests.tiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fastkmer_k28_text", "kmc2_k55_bin"])
def test_traced_run_on_the_card(config, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run(tiny_cell(config, genome=200_000, coverage=8), 2**31 + 9, 1.0, True,
                    "cuda", tmp_root=str(tmp_path))
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    assert 0 < r["metrics"]["kernel_a_roofline"]["value"] <= 105
    assert 0 <= r["metrics"]["device_idle_pct"]["value"] < 100
