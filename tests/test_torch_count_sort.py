"""fastkmer_tpu_torch.ops.{count_sort,binhash} vs fastkmer_tpu's on the same
numpy columns.  Integer outputs, so the tolerance is bit-equality."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fastkmer_tpu.core import bits  # noqa: E402
from fastkmer_tpu.ops import binhash as jbh  # noqa: E402
from fastkmer_tpu.ops import count_sort as jcs  # noqa: E402
from fastkmer_tpu_torch.ops import binhash as tbh  # noqa: E402
from fastkmer_tpu_torch.ops import count_sort as tcs  # noqa: E402

N = 4096  # a multiple of the JAX compaction block


def sentineled_cols(seed: int, W: int, n_distinct: int = 300):
    """W uint32 key lanes with heavy duplication, full-range values (the
    unsigned order matters) and ~10% all-ones sentinel rows; the last lane
    keeps zero low bits, as a sentinel-safe k-mer word does."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, size=(n_distinct, W), dtype=np.uint64).astype(np.uint32)
    pool[:, -1] &= np.uint32(0xFFFFFFF0)
    pool[0] = 0
    pool[1, 0] = 0xFFFFFFFF  # all-ones in a leading lane is a valid key
    rows = pool[rng.integers(0, n_distinct, N)]
    rows[rng.random(N) < 0.1] = 0xFFFFFFFF
    return [np.ascontiguousarray(rows[:, w]) for w in range(W)], rng


def _torch_cols(cols):
    return [torch.from_numpy(c.view(np.int32)) for c in cols]


def _assert_sorted_counts_equal(t, j):
    np.testing.assert_array_equal(t.words.numpy().view(np.uint32), np.asarray(j.words))
    np.testing.assert_array_equal(t.is_uniq.numpy(), np.asarray(j.is_uniq))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    assert int(t.n_valid) == int(j.n_valid)


@pytest.mark.parametrize("W", [1, 2, 3, 5])
def test_count_presentineled_unweighted(W):
    cols, _ = sentineled_cols(W, W)
    j = jcs.count_presentineled([jnp.asarray(c) for c in cols])
    t = tcs.count_presentineled(_torch_cols(cols))
    _assert_sorted_counts_equal(t, j)
    assert t.is_uniq.any()


@pytest.mark.parametrize("W", [1, 2, 3, 5])
def test_count_presentineled_weighted(W):
    cols, rng = sentineled_cols(10 + W, W)
    wts = rng.integers(1, 1000, N).astype(np.int32)
    wts[cols[-1] == 0xFFFFFFFF] = 0  # sentinel rows carry no weight
    j = jcs.count_presentineled([jnp.asarray(c) for c in cols], weights=jnp.asarray(wts))
    t = tcs.count_presentineled(_torch_cols(cols), weights=torch.from_numpy(wts))
    _assert_sorted_counts_equal(t, j)


@pytest.mark.parametrize("W,slack", [(2, 7), (3, 0), (2, -40), (4, -1)])
def test_compact_marked(W, slack):
    """Compaction at a capacity above, at, and below (forced overflow) the
    distinct count: same rows in the same order, same n_u and overflow."""
    cols, _ = sentineled_cols(20 + W, W)
    jsc = jcs.count_presentineled([jnp.asarray(c) for c in cols])
    tsc = tcs.count_presentineled(_torch_cols(cols))
    n_u = int(np.asarray(jsc.is_uniq).sum())
    cap = n_u + slack
    jout = jcs.compact_marked(
        tuple(jsc.words[:, w] for w in range(W)), jsc.counts, jsc.is_uniq, cap
    )
    tout = tcs.compact_marked(tuple(tsc.words.unbind(1)), tsc.counts, tsc.is_uniq, cap)
    for tc, jc in zip(tout[0], jout[0]):
        np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert int(tout[2]) == int(jout[2]) == n_u
    assert int(tout[3]) == int(jout[3]) == max(0, -slack)


def test_weight_limit_and_sentinel_safety():
    assert tcs.WEIGHT_LIMIT == jcs.WEIGHT_LIMIT
    for k in range(5, 70):
        assert tcs.sentinel_safe_for(k) == jcs.sentinel_safe_for(k)


@pytest.mark.parametrize("k,m,B", [(13, 4, 32), (28, 10, 512), (32, 9, 64),
                                   (33, 7, 2000), (97, 13, 97)])
def test_bins_from_words(k, m, B):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(300, k)).astype(np.uint8)
    codes[0] = 0  # all-A: every forward m-mer disallowed
    codes[1] = 3
    words = np.array([bits.pack_kmer_words(c, k) for c in codes], np.uint32)
    got = tbh.bins_from_words(torch.from_numpy(words.view(np.int32)), k, m, B)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbh.bins_from_words(jnp.asarray(words), k, m, B)))
    sigs = tbh.signatures_from_words(torch.from_numpy(words.view(np.int32)), k, m)
    np.testing.assert_array_equal(
        sigs.numpy(), np.asarray(jbh.signatures_from_words(jnp.asarray(words), k, m))
    )


def kmer_rows(seed: int, k: int, n_distinct: int = 400):
    """N packed k-mer rows (uint32 [N, W]) drawn with heavy duplication from
    random k-mers, ~10% invalid; at k % 16 == 0 some valid AND some invalid
    rows are all-T (all-ones words, the bare sentinel).  Bins are a function
    of the words, as a k-mer's bin is."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n_distinct, k)).astype(np.uint8)
    codes[0] = 3
    pool = np.array([bits.pack_kmer_words(c, k) for c in codes], np.uint32)
    pick = rng.integers(0, n_distinct, N)
    pick[:8] = 0  # all-T rows, valid and invalid
    words = pool[pick]
    valid = rng.random(N) >= 0.1
    valid[:8] = [True, False] * 4
    bins = (pick % 61).astype(np.int32)
    weights = rng.integers(1, 500, N).astype(np.int32)
    return words, valid, bins, weights


@pytest.mark.parametrize("k,sentinel_safe", [(28, True), (28, False), (13, True), (32, False),
                                             (64, False)])
@pytest.mark.parametrize("with_bins,with_weights", [(False, False), (True, False),
                                                    (False, True), (True, True)])
def test_count_sorted(k, sentinel_safe, with_bins, with_weights):
    words, valid, bins, weights = kmer_rows(k + 3, k)
    jb = jnp.asarray(bins) if with_bins else None
    jw = jnp.asarray(weights) if with_weights else None
    j = jcs.count_sorted(jnp.asarray(words), jb, jnp.asarray(valid), jw,
                         sentinel_safe=sentinel_safe)
    t = tcs.count_sorted(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(bins) if with_bins else None,
        torch.from_numpy(valid),
        torch.from_numpy(weights) if with_weights else None,
        sentinel_safe=sentinel_safe,
    )
    iu = np.asarray(j.is_uniq)
    np.testing.assert_array_equal(t.is_uniq.numpy(), iu)
    np.testing.assert_array_equal(t.words.numpy().view(np.uint32)[iu], np.asarray(j.words)[iu])
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    assert int(t.n_valid) == int(j.n_valid)
    assert (t.bins is None) == (j.bins is None)
    if with_bins:
        np.testing.assert_array_equal(t.bins.numpy()[iu], np.asarray(j.bins)[iu])
    if k % 16 == 0:
        # the valid all-T row is counted apart from the invalid all-T rows
        allt = (t.words.numpy().view(np.uint32) == 0xFFFFFFFF).all(1) & iu
        assert allt.sum() == 1


def test_bin_histogram():
    rng = np.random.default_rng(3)
    B = 64
    bins = rng.integers(0, B, 5000).astype(np.int32)
    valid = rng.random(5000) < 0.8
    want = np.asarray(jcs.bin_histogram(jnp.asarray(bins), jnp.asarray(valid), B))
    got = tcs.bin_histogram(torch.from_numpy(bins), torch.from_numpy(valid), B)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)
