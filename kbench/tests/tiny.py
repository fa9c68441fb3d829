"""Cells cut to a size the CPU tests can run: a 30,000-base genome (at 4x
coverage where the traffic draws reads), [64, 512] batches."""

from __future__ import annotations

from kbench import spec

GENOME = 30_000
TRAFFIC = {"fastkmer_k28_text": "genome_g16m", "kmc2_k55_bin": "reads64x_g1m_err"}


def tiny_cell(config: str, genome: int = GENOME, coverage: int = 4, **traffic) -> spec.Cell:
    cfg = dict(spec.config(config))
    argv = list(cfg["argv"])
    argv[argv.index("--reads-per-batch") + 1] = "64"
    argv[argv.index("--read-len") + 1] = "512"
    cfg["argv"] = argv
    tr = dict(spec.traffic(TRAFFIC[config]), genome_bases=genome, coverage=coverage,
              **traffic)
    bench = spec.load_benchmark()
    return spec.Cell(f"tiny.{config}", 1, cfg, tr, bench["end_to_end"], bench["per_layer"])
