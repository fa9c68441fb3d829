"""The per-batch mesh count job of fastkmer_tpu_torch (8 CPU shards) vs
fastkmer_tpu's on a JAX mesh of 8 virtual CPU devices, on the dataset of
``test_driver_debug.py``: the same table, exchange bytes, balance and owner
map, and a byte-identical output directory, for k-mer and super-k-mer
transport under hash and LPT placement at k = 28 and 32.  Also: overflow
retries, the sync-free feed's overflow error, the knob that raises and the
knobs ported since.
(The streaming path is held against JAX in ``test_torch_stream_driver.py``.)
Integer outputs, so the tolerance is bit-equality."""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from fastkmer_tpu.config import JobConfig  # noqa: E402
from fastkmer_tpu.core import bits  # noqa: E402
from fastkmer_tpu.parallel import driver as jdriver  # noqa: E402
from fastkmer_tpu.parallel import exchange as jx  # noqa: E402
from fastkmer_tpu_torch import api as tapi  # noqa: E402
from fastkmer_tpu_torch.parallel import driver as tdriver  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange as tx  # noqa: E402

from . import oracles  # noqa: E402
from .test_pipeline_e2e import write_fasta  # noqa: E402
from .test_torch_cli import _dir_bytes  # noqa: E402

N_SHARDS = 8


def _reads() -> list[str]:
    rng = np.random.default_rng(21)
    reads = []
    for _ in range(50):
        ln = int(rng.integers(40, 300))
        chars = rng.choice(list("ACGT"), size=ln)
        chars[rng.random(ln) < 0.01] = "N"
        reads.append("".join(chars))
    return reads + ["T" * 64]  # the all-T edge at k % 16 == 0


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    reads = _reads()
    fa = str(tmp_path_factory.mktemp("mesh") / "reads.fa")
    write_fasta(fa, reads)
    return fa, reads


def _cfg(fa, out, k, m, part=False, tasks=0, write=True):
    return JobConfig(
        dataset=fa, output_directory=out, k=k, m=m, max_b=64, reads_per_batch=16,
        read_len=512, use_custom_partitioner=part, num_partition_tasks=tasks, write=write,
    )


@pytest.mark.parametrize("k,m", [(28, 10), (32, 9)])
@pytest.mark.parametrize("smer,part,tasks", [(False, False, 0), (False, True, 0),
                                             (True, False, 0), (True, True, 8)])
def test_execute_job_distributed_matches_jax(tmp_path, dataset, k, m, smer, part, tasks):
    fa, _ = dataset
    cfg = _cfg(fa, str(tmp_path) + "/out_", k, m, part, tasks)
    jmesh = jax.make_mesh((N_SHARDS,), (jx.AXIS,), devices=jax.devices("cpu")[:N_SHARDS])
    want = jdriver.execute_job_distributed(cfg, jmesh, smer_transport=smer, verbose=False,
                                           streaming=False)
    want_dir = _dir_bytes(cfg.output_dir)
    shutil.rmtree(cfg.output_dir)
    got = tdriver.execute_job_distributed(cfg, tx.make_mesh(N_SHARDS, "cpu"),
                                          smer_transport=smer, verbose=False, streaming=False)
    for f in ("words", "counts", "bins", "owner_map"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("n_instances", "n_bases", "n_reads", "exchange_bytes", "balance"):
        assert getattr(got, f) == getattr(want, f), f
    assert _dir_bytes(cfg.output_dir) == want_dir
    assert got.n_batches >= 1 and got.exchange_retries == 0
    for span in ("device_step", "host_compact", "merge", "write_output",
                 "lpt_prepass" if part else "cap_sizing"):
        assert span in got.timings


def test_undersized_cap_retries_to_the_exact_table(dataset):
    fa, reads = dataset
    cfg = _cfg(fa, "", 28, 10, write=False)
    for smer in (False, True):
        res = tdriver.execute_job_distributed(cfg, tx.make_mesh(3, "cpu"), cap=8,
                                              smer_transport=smer, verbose=False,
                                              streaming=False)
        assert res.exchange_retries > 0 and res.exchange_cap > 8
        kmers = bits.decode_words_batch(res.words, 28)
        got = {km.decode(): int(c) for km, c in zip(kmers, res.counts.tolist())}
        assert got == dict(oracles.count_reads(reads, 28))


def test_sync_free_feed_raises_on_a_drop(dataset):
    fa, _ = dataset
    cfg = _cfg(fa, "", 28, 10, write=False)
    mesh = tx.make_mesh(3, "cpu")
    with pytest.raises(RuntimeError, match="sync-free per-batch run dropped"):
        tdriver.execute_job_distributed(cfg, mesh, cap=8, smer_transport=True,
                                        verbose=False, unique_ub=1 << 20)
    res = tdriver.execute_job_distributed(cfg, mesh, smer_transport=True, verbose=False,
                                          unique_ub=1 << 20)
    assert res.n_instances > 0 and res.exchange_retries == 0


@pytest.mark.parametrize("kw,use_ht,msg", [
    ({"checkpoint_dir": "ck"}, False, "checkpoint_dir"),
    ({"keep_table": True}, False, "keep_table"),
    ({"smer_transport": True}, True, "useHT=1"),
    ({"smer_transport": True, "checkpoint_dir": "ck"}, False, "checkpoint_dir"),
    ({"smer_transport": True, "keep_table": True}, False, "keep_table"),
    ({"smer_transport": True, "trace_dir": "tr"}, False, "trace_dir"),
    ({"smer_transport": True, "prededup": True}, False, "prededup requires the streaming"),
])
def test_unported_knobs_raise(tmp_path, dataset, kw, use_ht, msg):
    """A forced prededup off the streaming path raises, as in the JAX
    package.  The knobs ported since (useHT=1, checkpoint_dir, keep_table,
    trace_dir) run on both mesh paths and leave their artifact."""
    fa, _ = dataset
    cfg = _cfg(fa, str(tmp_path) + "/out_", 28, 10)
    cfg.use_ht = use_ht
    kw = {a: str(tmp_path / v) if a.endswith("_dir") else v for a, v in kw.items()}
    mesh = tx.make_mesh(2, "cpu")
    if msg.startswith("prededup"):
        with pytest.raises(NotImplementedError, match=msg):
            tdriver.execute_job_distributed(cfg, mesh, verbose=False, **kw)
        assert not os.listdir(tmp_path)  # raised before any output
        return
    res = tdriver.execute_job_distributed(cfg, mesh, verbose=False, **kw)
    assert res.n_instances > 0 and tapi.verify_output(cfg.output_dir)["ok"]
    if "checkpoint_dir" in kw:
        assert not os.listdir(kw["checkpoint_dir"])  # emptied on completion
    if "trace_dir" in kw:
        assert os.listdir(kw["trace_dir"])
    assert os.path.exists(os.path.join(cfg.output_dir, "table.npz")) == ("keep_table" in kw)
    bins = [n for n in os.listdir(cfg.output_dir) if n.startswith("bin")]
    assert bins and all(open(os.path.join(cfg.output_dir, n), "rb").read().endswith(b"EOF")
                        != use_ht for n in bins)


def test_api_count_kmers_distributed(tmp_path, dataset):
    fa, reads = dataset
    res = tapi.count_kmers_distributed(fa, n_devices=4, k=28, m=10, bins=64, device="cpu",
                                       streaming=False, use_custom_partitioner=True,
                                       reads_per_batch=16, read_len=512)
    assert res.n_instances == sum(oracles.count_reads(reads, 28).values())
    assert res.balance["total"] > 0 and len(res.balance["loads"]) == 4
    streamed = tapi.count_kmers_distributed(fa, n_devices=2, k=28, m=10, bins=64,
                                            device="cpu")  # the streaming counter
    np.testing.assert_array_equal(streamed.words, res.words)
    np.testing.assert_array_equal(streamed.counts, res.counts)
