"""The streaming mesh job of fastkmer_tpu_torch (``execute_job_distributed``
with k-mer transport, ``cli.main --mesh 4``) vs fastkmer_tpu's on a JAX
mesh of 8 virtual CPU devices: the same table, owner map, exchange bytes
and dedup batch count, and a byte-identical output directory, for k = 28
and 32, hash and LPT placement, prededup auto/on/off, the sync-free feed,
a small accumulator (spills) and a small cap (window retries).  The CLI
run with FASTKMER_PALLAS_COMPACT=1 (the block-sort compaction) writes the
same bytes as the run without it.  Integer outputs, so the tolerance is
bit-equality."""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from fastkmer_tpu import cli as jcli  # noqa: E402
from fastkmer_tpu.config import JobConfig  # noqa: E402
from fastkmer_tpu.parallel import driver as jdriver  # noqa: E402
from fastkmer_tpu.parallel import exchange as jx  # noqa: E402
from fastkmer_tpu_torch import api as tapi  # noqa: E402
from fastkmer_tpu_torch import cli as tcli  # noqa: E402
from fastkmer_tpu_torch.parallel import driver as tdriver  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange as tx  # noqa: E402

from . import oracles  # noqa: E402
from .test_pipeline_e2e import write_fasta  # noqa: E402
from .test_torch_cli import _dir_bytes  # noqa: E402
from .test_torch_pipeline import mixed_reads  # noqa: E402

N_SHARDS = 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    reads = mixed_reads(11, n=60)
    fa = str(tmp_path_factory.mktemp("stream") / "reads.fa")
    write_fasta(fa, reads)
    return fa, reads


def _cfg(fa, out, k, m, part=False, tasks=0):
    return JobConfig(dataset=fa, output_directory=out, k=k, m=m, max_b=64,
                     reads_per_batch=8, read_len=256, use_custom_partitioner=part,
                     num_partition_tasks=tasks)


# One JAX job per case, shared by the port's two compaction routes: k, m,
# LPT placement, LPT tasks, driver options.
CASES = {
    "k28-hash-retry": (28, 10, False, 0, {"cap": 8}),
    "k32-lpt8-on-spill": (32, 9, True, 8, {"prededup": True, "acc_cap": 2048, "fanin": 2}),
    "k32-hash-off-syncfree": (32, 9, False, 0, {"prededup": False, "unique_ub": 1 << 16}),
}
# Each case with the prefix-sum compaction, and those whose merges are small
# enough for the block sort's plain version on the CPU with it too.
ROUTES = [pytest.param(n, b, id=f"{n}-{'block_sort' if b else 'scatter'}")
          for n in CASES for b in (False, True) if not (b and "unique_ub" in CASES[n][4])]
_JAX_RUNS = {}


def _jax_job(tmp_path_factory, fa, name):
    """The JAX job of CASES[name], run once per module: its config, result
    and output bytes.  Its output directory is emptied for the port, which
    writes to the same path (the manifest records it)."""
    if name not in _JAX_RUNS:
        k, m, part, tasks, kw = CASES[name]
        cfg = _cfg(fa, str(tmp_path_factory.mktemp("job")) + "/out_", k, m, part, tasks)
        jmesh = jax.make_mesh((N_SHARDS,), (jx.AXIS,), devices=jax.devices("cpu")[:N_SHARDS])
        want = jdriver.execute_job_distributed(cfg, jmesh, verbose=False, **kw)
        _JAX_RUNS[name] = cfg, want, _dir_bytes(cfg.output_dir)
        shutil.rmtree(cfg.output_dir)
    return _JAX_RUNS[name]


@pytest.mark.parametrize("name,block_sort", ROUTES)
def test_streaming_job_matches_jax(tmp_path_factory, dataset, monkeypatch, name, block_sort):
    """The same table, owner map, counters and output bytes as the JAX job,
    with compaction by prefix-sum scatter or by the block sort
    (FASTKMER_PALLAS_COMPACT=1)."""
    fa, reads = dataset
    cfg, want, want_dir = _jax_job(tmp_path_factory, fa, name)
    kw = CASES[name][4]
    if block_sort:
        monkeypatch.setenv("FASTKMER_PALLAS_COMPACT", "1")
    got = tdriver.execute_job_distributed(cfg, tx.make_mesh(N_SHARDS, "cpu"), verbose=False,
                                          **kw)
    for f in ("words", "counts", "bins", "owner_map"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("n_instances", "n_bases", "n_reads", "exchange_bytes", "balance",
              "n_dedup_batches"):
        assert getattr(got, f) == getattr(want, f), f
    assert _dir_bytes(cfg.output_dir) == want_dir
    shutil.rmtree(cfg.output_dir)
    assert got.n_instances == sum(oracles.count_reads(reads, cfg.k).values())
    assert got.n_batches > 1
    assert (got.exchange_retries > 0) == ("cap" in kw)
    part = cfg.use_custom_partitioner
    sizing = "lpt_prepass" if part else "cap_sizing" if "cap" not in kw else "merge"
    for span in ("device_step", "merge", "write_output", sizing):
        assert span in got.timings


_JAX_CLI = {}


def _jax_cli(tmp_path_factory, fa):
    """The JAX CLI's ``--mesh 4`` run with ``--prededup auto``, once per
    module: its argv, output directory, output bytes and summary.  The
    directory is emptied for the port, which writes to the same path;
    ``--prededup`` changes no output byte."""
    if not _JAX_CLI:
        out = str(tmp_path_factory.mktemp("cli")) + "/"
        argv = ["28", "10", "3", "64", "0", "0", fa, out, "s_", "1", "0", "1", "4",
                "--mesh", "4", "--reads-per-batch", "8", "--read-len", "256"]
        stats = out + "jax_stats.json"
        assert jcli.main(argv + ["--platform", "cpu", "--stats-json", stats]) == 0
        d = os.path.join(out, "s_k28_m10_x3_b64_s0")
        _JAX_CLI.update(argv=argv, d=d, bytes=_dir_bytes(d), summary=json.load(open(stats)))
        shutil.rmtree(d)
    return _JAX_CLI


@pytest.mark.parametrize("prededup", ["auto", "on"])
def test_streaming_cli_matches_jax_and_block_sort(tmp_path, tmp_path_factory, dataset,
                                                  monkeypatch, prededup):
    """``--mesh 4`` (streaming) on the CPU: the JAX CLI, the port, and the
    port with FASTKMER_PALLAS_COMPACT=1 write identical directories; with
    ``--prededup auto`` the port sends the JAX run's exchange bytes, with
    ``on`` it dedups every batch."""
    jax_run = _jax_cli(tmp_path_factory, dataset[0])
    stats = str(tmp_path / "stats.json")
    summaries = []
    for block_sort in (False, True):
        if block_sort:
            monkeypatch.setenv("FASTKMER_PALLAS_COMPACT", "1")
        argv = jax_run["argv"] + ["--prededup", prededup, "--device", "cpu", "--stats-json", stats]
        assert tcli.main(argv) == 0
        assert _dir_bytes(jax_run["d"]) == jax_run["bytes"]
        shutil.rmtree(jax_run["d"])
        summaries.append(json.load(open(stats)))
    want = jax_run["summary"]
    for s in summaries:
        assert s["placement"] == ["cpu"] * 4 and s["mesh"] == 4 and s["prededup"] == prededup
        assert s["exchange_bytes"] == summaries[0]["exchange_bytes"] > 0
        if prededup == "auto":
            for f in ("exchange_bytes", "n_dedup_batches", "n_instances", "n_unique"):
                assert s[f] == want[f], f
        else:
            assert s["n_dedup_batches"] == s["n_batches"] > 1


def test_api_streaming_default(dataset):
    fa, reads = dataset
    res = tapi.count_kmers_distributed(fa, n_devices=4, k=28, m=10, bins=64, device="cpu",
                                       reads_per_batch=8, read_len=256)
    assert res.n_instances == sum(oracles.count_reads(reads, 28).values())
    assert res.n_dedup_batches >= 1 and res.n_batches > 1
