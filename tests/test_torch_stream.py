"""The streaming mesh counter of fastkmer_tpu_torch
(``parallel.stream.DistributedCounter`` on 8 CPU shards) vs fastkmer_tpu's
on a JAX mesh of 8 virtual CPU devices: the same table (words, counts,
bins), the same merge windows, and equal ``exchange_bytes``,
``n_dedup_batches``, ``n_retries``, ``cap`` and ``cap_d``, through the
raw and dedup transports, the adaptive controller, spills, window
retries, the sync-free feed, the zero sequence lane of k % 16 == 0 and a
sequence lane of real ids (multiseq's).  Integer outputs, so the tolerance is bit-equality."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from fastkmer_tpu.parallel import exchange as jx  # noqa: E402
from fastkmer_tpu.parallel import partitioner as jpart  # noqa: E402
from fastkmer_tpu.parallel import stream as jstream  # noqa: E402
from fastkmer_tpu_torch.core.bits import num_words  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange as tx  # noqa: E402
from fastkmer_tpu_torch.parallel import stream as tstream  # noqa: E402

from . import oracles  # noqa: E402
from .test_extract import random_reads, to_batch  # noqa: E402
from .test_stream_dedup import dup_heavy_reads  # noqa: E402

N_SHARDS = 8
B = 64


@pytest.fixture(scope="module")
def meshes():
    jmesh = jax.make_mesh((N_SHARDS,), (jx.AXIS,), devices=jax.devices("cpu")[:N_SHARDS])
    return jmesh, tx.make_mesh(N_SHARDS, "cpu")


def _batches(seed: int, kind: str) -> list:
    """6 batches of 32 reads of <= 100 bases: 'random', 'dup' (reads of a
    150-base genome, an in-batch distinct ratio near 0.1) or 'mixed'
    (3 random batches, then dup-heavy ones)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        dup = kind == "dup" or (kind == "mixed" and i >= 3)
        reads = dup_heavy_reads(rng, 32, 100, genome_len=150) if dup else random_reads(rng, 32, 100)
        out.append(reads)
    return out


def _owner(placement: str, k: int, m: int) -> np.ndarray:
    if placement == "hash":
        return jpart.hash_owner_map(B, N_SHARDS)
    hist = np.random.default_rng(k + m).integers(0, 1000, size=B)
    return jpart.lpt_owner_map(hist, N_SHARDS, B) % N_SHARDS


def _feed(ctr, batches, with_seq: bool):
    for reads in batches:
        codes = to_batch(reads, 100)
        sids = np.zeros(codes.shape[0], np.int32) if with_seq else None
        ctr.feed(codes, n_reads=len(reads), seq_ids=sids)
    return ctr.finalize()


# One JAX run per case, shared by the port's two compaction routes.  Each
# case: k, m, placement, prededup, data, counter options, then what the run
# must show (the controller engaged, host spills, window retries, the
# sync-free feed).
CASES = {
    "k28-hash-auto-retry": (28, 10, "hash", None, "mixed", {"cap": 8, "acc_cap": 1 << 14},
                            {"engaged", "retries"}),
    "k28-lpt-on-spill": (28, 10, "lpt", True, "random",
                         {"cap": 2048, "acc_cap": 2048, "fanin": 1}, {"spills"}),
    "k28-hash-auto-spill": (28, 10, "hash", None, "random",
                            {"cap": 2048, "acc_cap": 2048, "fanin": 1}, {"engaged", "spills"}),
    "k32-lpt-auto-syncfree": (32, 9, "lpt", None, "mixed",
                              {"cap": 2048, "acc_cap": 1 << 12, "unique_ub": 1 << 14},
                              {"engaged", "sync_free"}),
    "k32-hash-off-retry": (32, 9, "hash", False, "dup", {"cap": 8, "acc_cap": 1 << 14},
                           {"retries"}),
}
# Each case with the prefix-sum compaction, and those whose merges are small
# enough for the block sort's plain version on the CPU with it too.
ROUTES = [pytest.param(n, b, id=f"{n}-{'block_sort' if b else 'scatter'}")
          for n in CASES for b in (False, True) if not (b and "sync_free" in CASES[n][6])]
_JAX_RUNS = {}


def _jax_run(meshes, name):
    """The JAX counter's run of CASES[name], made once per module."""
    if name not in _JAX_RUNS:
        k, m, placement, prededup, kind, kw, _ = CASES[name]
        batches = _batches(k + len(kind), kind)
        jctr = jstream.DistributedCounter(meshes[0], k, m, B, owner_map=_owner(placement, k, m),
                                          with_seq=k % 16 == 0, prededup=prededup, **kw)
        _JAX_RUNS[name] = batches, jctr, _feed(jctr, batches, k % 16 == 0)
    return _JAX_RUNS[name]


@pytest.mark.parametrize("name,block_sort", ROUTES)
def test_counter_matches_jax(meshes, monkeypatch, name, block_sort):
    """The same table, merge windows, spills and counters as the JAX
    counter, with compaction by prefix-sum scatter or by the block sort
    (FASTKMER_PALLAS_COMPACT=1)."""
    k, m, placement, prededup, _, kw, shows = CASES[name]
    batches, jctr, want = _jax_run(meshes, name)
    if block_sort:
        monkeypatch.setenv("FASTKMER_PALLAS_COMPACT", "1")
    tctr = tstream.DistributedCounter(meshes[1], k, m, B, owner_map=_owner(placement, k, m),
                                      with_seq=k % 16 == 0, prededup=prededup, **kw)
    assert tctr.block_sort == block_sort
    got = _feed(tctr, batches, k % 16 == 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for f in ("exchange_bytes", "n_dedup_batches", "n_retries", "cap", "cap_d", "acc_cap",
              "n_reads", "_dedup_mode"):
        assert getattr(tctr, f) == getattr(jctr, f), f
    assert tctr.merge_rows == [r for r, _ in jctr.merge_shapes]
    assert len(tctr.host_spills) == len(jctr.host_spills)
    expect = oracles.count_reads([r for b in batches for r in b], k)
    assert int(got[1].sum()) == sum(expect.values())
    # what each case is there for
    if prededup is None:
        assert (tctr.n_dedup_batches > 1) == ("engaged" in shows)
    assert bool(tctr.host_spills) == ("spills" in shows)
    assert (tctr.n_retries > 0) == ("retries" in shows)
    if "retries" in shows:
        assert tctr.cap > 8
    if "sync_free" in shows:
        assert tctr.assume_fits and tctr.acc_cap == 3 << 16 and not tctr._window


@pytest.mark.parametrize("kw", [{"unique_ub": 1 << 20}, {"retry_on_overflow": False}])
def test_drops_raise_at_finalize(meshes, kw):
    """A sync-free feed, or a feed without retries, that dropped rows
    raises when finalized, as the JAX counter does."""
    _, tmesh = meshes
    ctr = tstream.DistributedCounter(tmesh, 28, 10, B, cap=8, acc_cap=1 << 14,
                                     owner_map=jpart.hash_owner_map(B, N_SHARDS), **kw)
    ctr.feed(to_batch(random_reads(np.random.default_rng(3), 32, 100), 100))
    with pytest.raises(RuntimeError, match="exchange overflow"):
        ctr.finalize()


def test_k_multiple_of_16_needs_the_seq_lane(meshes):
    _, tmesh = meshes
    with pytest.raises(ValueError, match="k % 16 != 0"):
        tstream.DistributedCounter(tmesh, 32, 9, B, cap=64, acc_cap=1 << 14,
                                   owner_map=jpart.hash_owner_map(B, N_SHARDS))


@pytest.mark.parametrize("k,m,prededup", [(28, 10, True), (28, 10, False), (32, 9, None)])
def test_seq_lane_with_real_ids_matches_jax(meshes, k, m, prededup):
    """The seq lane with real ids (0-2 per read, as multiseq feeds it),
    through the dedup transport, the raw one and the adaptive controller:
    the JAX counter's (k-mer, seq) table, ``exchange_bytes`` and dedup
    batches; rows of one k-mer ascend by sequence id."""
    rng = np.random.default_rng(67 + k)
    batches = [(dup_heavy_reads(rng, 32, 100), rng.integers(0, 3, size=32).astype(np.int32))
               for _ in range(4)]
    owner = jpart.hash_owner_map(B, N_SHARDS)
    kw = dict(cap=2048, acc_cap=1 << 14, with_seq=True, prededup=prededup)
    jctr = jstream.DistributedCounter(meshes[0], k, m, B, owner_map=owner, **kw)
    tctr = tstream.DistributedCounter(meshes[1], k, m, B, owner_map=owner, **kw)
    for ctr in (jctr, tctr):
        for reads, sids in batches:
            ctr.feed(to_batch(reads, 100), n_reads=len(reads), seq_ids=sids.copy())
    want, got = jctr.finalize(), tctr.finalize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for f in ("exchange_bytes", "n_dedup_batches", "n_retries", "cap_d"):
        assert getattr(tctr, f) == getattr(jctr, f), f
    assert (tctr.n_dedup_batches == 4) == (prededup is True)
    W = num_words(k)
    same = np.all(got[0][1:, :W] == got[0][:-1, :W], axis=1)
    assert same.any() and (got[0][1:, W][same] > got[0][:-1, W][same]).all()
    assert set(np.unique(got[0][:, W]).tolist()) == {0, 1, 2}
