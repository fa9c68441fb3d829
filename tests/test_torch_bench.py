"""The port's bench workload (``fastkmer_tpu_torch.bench``) vs the JAX
package fed the same batches the same way, on the CPU at a small size:
R=64, L=256, 4 batches of reads from a 2^13-base genome, fan-in 2.  Each
mode's final table (words, counts, bins) is bit-equal to the JAX
``DeviceAccumulator``'s (stream, percount, dedup) or ``count_batches``'
(adaptive, forced, raw) table; the step mode's sorted counts are the JAX
per-batch count's.  Also ``DeviceAccumulator.add`` against the JAX ``add``
on pre-counted batches (as ``tests/test_pipeline_e2e.py`` uses it) at
k=28 and at k=32, where the port's words carry the flag lane.  Integer
outputs, so the tolerance is bit-equality; each JAX run is made once per
module."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import bench as jbench  # noqa: E402
from fastkmer_tpu import pipeline as jpipe  # noqa: E402
from fastkmer_tpu_torch import bench as tbench  # noqa: E402
from fastkmer_tpu_torch import pipeline as tpipe  # noqa: E402
from fastkmer_tpu_torch.core.bits import decode_words_batch, num_words  # noqa: E402

from . import oracles  # noqa: E402
from .test_extract import random_reads, to_batch  # noqa: E402

R, L, NB, G, FANIN = 64, 256, 4, 1 << 13, 2


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the port's CPU runs here are many small ops, which
    several test workers' thread pools would otherwise fight over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
K, M, B = tbench.K, tbench.M, tbench.B


def _jax_feed(batches, mode):
    """bench.py's feed on the JAX package (its plain extract, as on a CPU
    backend) -> the final table."""
    acc = jpipe.DeviceAccumulator(K, fanin=FANIN, m=M, B=B, unique_ub=G)
    npos = R * (L - K + 1)
    dcap = (npos + (-npos % (1 << 16))) // 4
    for i, codes in enumerate(batches):
        if mode == "stream" and i % 16 == 0:
            *_, raw = jpipe._batch_count_dedup(codes, K, M, B, dcap, False)
            acc.add_raw(raw)
        elif mode == "percount":
            acc.add(jpipe._batch_count(codes, K, M, B))
        elif mode == "dedup":
            dcols, dwts, _, over, _ = jpipe._batch_count_dedup(codes, K, M, B, dcap, False)
            assert int(over) == 0
            acc.add_part(dcols, dwts)
        else:
            acc.add_raw(jpipe._batch_extract_keys(codes, K, M, B, False))
    return acc.finalize()


@pytest.fixture(scope="module")
def jax_tables():
    batches = [jnp.asarray(b) for b in tbench.make_batches(np.random.default_rng(0), R, L, NB, G)]
    out = {mode: _jax_feed(batches, mode) for mode in ("stream", "percount", "dedup")}
    for mode, prededup in tbench.CONTROLLER.items():
        res = jpipe.count_batches(((c, 0, 0) for c in batches), K, M, B, unique_ub=G,
                                  prededup=prededup, device_accumulate=True)
        out[mode] = (res.words, res.counts, res.bins)
    out["step"] = jpipe._batch_count(batches[0], K, M, B)
    return out


def test_batches_are_bench_py_draw_for_draw(monkeypatch):
    for name, v in (("R", R), ("L", L), ("NBATCH", NB), ("GENOME", G)):
        monkeypatch.setattr(jbench, name, v)
    want = jbench.make_batches(np.random.default_rng(0))
    got = tbench.make_batches(np.random.default_rng(0), R, L, NB, G)
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got) == NB


@pytest.mark.parametrize("mode", ["stream", "percount", "dedup", "adaptive", "forced", "raw"])
def test_mode_table_is_the_jax_one(jax_tables, mode):
    rec, table = tbench.run(mode, R=R, L=L, n_batch=NB, genome=G, fanin=FANIN, device="cpu")
    want = jax_tables[mode]
    for got, ref in zip(table, want):
        np.testing.assert_array_equal(got, np.asarray(ref))
    assert rec["metric"] == tbench.metric_name(mode, False) == (
        f"stream_{mode}_throughput_k28_m10" if mode != "stream"
        else "stream_count_throughput_k28_m10")
    assert rec["unit"] == "Gbp/s" and rec["value"] > 0 and rec["device"] == "cpu"
    assert "vs_baseline" not in rec and "baseline_device" not in rec
    if mode == "stream":
        assert rec["extra"]["step_gbps"] > 0


def test_step_is_the_jax_per_batch_count(jax_tables):
    codes = torch.from_numpy(tbench.make_batches(np.random.default_rng(0), R, L, 1, G)[0])
    sc = tpipe._batch_count_sorted(codes, K, M, B)
    ref = jax_tables["step"]
    np.testing.assert_array_equal(sc.words.numpy().view(np.uint32), np.asarray(ref.words))
    np.testing.assert_array_equal(sc.is_uniq.numpy(), np.asarray(ref.is_uniq))
    np.testing.assert_array_equal(sc.counts.numpy(), np.asarray(ref.counts))
    assert sc.bins is None and int(sc.n_valid) == int(ref.n_valid)
    rec, table = tbench.run("step", R=R, L=L, n_batch=1, genome=G, device="cpu")
    assert table is None and rec["metric"] == "count_step_throughput_k28_m10"


def test_dup_metric_and_sanity_checks():
    assert tbench.metric_name("raw", True) == "stream_raw_throughput_k28_m10_dup"
    assert tbench.metric_name("step", True) == "count_step_throughput_k28_m10"
    names = {tbench.metric_name(m, d) for m in tbench.MODES for d in (False, True)}
    assert len(names) == 2 * len(tbench.MODES) - 1  # the step line has no dup name
    # one batch of a 2^20-base genome covers far less than half of it
    with pytest.raises(RuntimeError, match="distinct count"):
        tbench.run("stream", R=R, L=L, n_batch=1, genome=1 << 20, fanin=FANIN, device="cpu")


def _reads(seed: int, n: int = 48) -> list[str]:
    rng = np.random.default_rng(seed)
    reads = random_reads(rng, n, 100)
    reads[::5] = [reads[0]] * len(reads[::5])  # duplicates across batches
    return reads


@pytest.mark.parametrize("k,m", [(28, 10), (32, 9)])
def test_add_is_the_jax_add(k, m):
    """Pre-counted batches through ``add`` (fan-in 2: several merges)."""
    Bk = 64
    batches = [to_batch(_reads(k)[i:i + 8], 100) for i in range(0, 48, 8)]
    jacc = jpipe.DeviceAccumulator(k, fanin=2, m=m, B=Bk)
    tacc = tpipe.DeviceAccumulator(k, fanin=2, m=m, B=Bk, device="cpu",
                                   extra_lanes=0 if k % 16 else 1)
    for codes in batches:
        jacc.add(jpipe._batch_count(jnp.asarray(codes), k, m, Bk))
        tacc.add(tpipe._batch_count_sorted(torch.from_numpy(codes), k, m, Bk))
    jw, jc, jb = jacc.finalize()
    tw, tc, tb = tacc.finalize()
    W = num_words(k)
    np.testing.assert_array_equal(tw[:, :W], np.asarray(jw))
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(tb, np.asarray(jb))
    if k % 16 == 0:
        assert tw.shape[1] == W + 1 and not tw[:, W].any()  # the flag lane: 0 on every row


def test_add_keeps_the_all_t_kmer_at_k32():
    """At k % 16 == 0 the all-T k-mer is all-ones, the sentinel's pattern:
    the flag lane keeps it a k-mer (count against the oracle), and an
    accumulator without the lane refuses the batch."""
    k, m, Bk = 32, 9, 64
    reads = ["T" * 40, "T" * 35 + "A" * 10, "ACGT" * 12]
    codes = torch.from_numpy(to_batch(reads, 100))
    acc = tpipe.DeviceAccumulator(k, fanin=2, m=m, B=Bk, device="cpu", extra_lanes=1)
    acc.add(tpipe._batch_count_sorted(codes, k, m, Bk))
    words, counts, _ = acc.finalize()
    got = dict(zip(decode_words_batch(words[:, :2], k), counts.tolist()))
    assert got == {km.encode(): c for km, c in oracles.count_reads(reads, k).items()}
    assert b"A" * 32 in got  # T*32's canonical form
    with pytest.raises(ValueError, match="key lanes"):
        tpipe.DeviceAccumulator(k, device="cpu").add(tpipe._batch_count_sorted(codes, k, m, Bk))
