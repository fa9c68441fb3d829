"""Kernel C's plain version and the block-sort compaction of
fastkmer_tpu_torch vs fastkmer_tpu on the CPU.

``cuda_sort.sort_blocks_reference`` against the Pallas kernel
``pallas_sort.sort_blocks(interpret=True)`` on the cases of
``test_pallas_sort.py`` (sentinels, ties, 1-3 keys, carried values): keys
bit-equal per block, row multisets equal per block.  ``compact_marked``
with ``block_sort=True`` against JAX ``compact_marked`` (its Pallas path
where the block divides N, its lax path otherwise) and against the port's
default prefix-sum path, with overflow past ``out_cap`` and N not a block
multiple.  Integer outputs, so the tolerance is bit-equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from fastkmer_tpu.ops import count_sort as jcs  # noqa: E402
from fastkmer_tpu.ops import pallas_sort  # noqa: E402
from fastkmer_tpu_torch.ops import count_sort as tcs  # noqa: E402
from fastkmer_tpu_torch.ops import cuda_sort  # noqa: E402

from .test_pallas_sort import _mk_cols  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a).view(np.int32))


def _rows(cols, sl):
    r = np.stack([c[sl] for c in cols], 1)
    return r[np.lexsort(r.T[::-1])]


@pytest.mark.parametrize(
    "n_keys,n_vals,block,N",
    [(1, 0, 1024, 2048), (2, 1, 1024, 4096), (2, 1, 2048, 2048), (3, 2, 1024, 1024)],
)
def test_reference_matches_pallas_sort_blocks(n_keys, n_vals, block, N):
    cols = _mk_cols(np.random.default_rng(7), n_keys, n_vals, N)
    want = [np.asarray(o) for o in pallas_sort.sort_blocks(
        tuple(jnp.asarray(c) for c in cols), num_keys=n_keys, block=block, interpret=True)]
    before = cuda_sort.LAUNCHES
    got = cuda_sort.sort_blocks(tuple(_t(c) for c in cols), n_keys, block)
    assert cuda_sort.LAUNCHES == before  # a CPU tensor takes the plain version
    got = [g.numpy().view(np.uint32) for g in got]
    for b in range(N // block):
        sl = slice(b * block, (b + 1) * block)
        for i in range(n_keys):
            np.testing.assert_array_equal(got[i][sl], want[i][sl])
        np.testing.assert_array_equal(_rows(got, sl), _rows(cols, sl))
        np.testing.assert_array_equal(_rows(got, sl), _rows(want, sl))


def test_reference_checks_its_arguments():
    lanes = (torch.zeros(2048, dtype=torch.int32),) * 2
    for kw, err in (({"num_keys": 3, "block": 1024}, ValueError),
                    ({"num_keys": 1, "block": 512}, ValueError),
                    ({"num_keys": 1, "block": 1536}, ValueError),
                    ({"num_keys": 1, "block": 4096}, ValueError)):
        with pytest.raises(err):
            cuda_sort.sort_blocks(lanes, **kw)
    with pytest.raises(TypeError):
        cuda_sort.sort_blocks((torch.zeros(2048, dtype=torch.int64),), 1, 1024)
    assert cuda_sort.tile_rows(3, 1 << 15) == 1 << 14
    assert cuda_sort.tile_rows(4, 1 << 15) == 1 << 13
    assert cuda_sort.tile_rows(14, 1 << 15) == 1 << 12
    with pytest.raises(ValueError, match="do not fit"):
        cuda_sort.tile_rows(57, 1 << 15)


def test_in_place_sort_matches_the_copying_one():
    lanes = tuple(_t(c) for c in _mk_cols(np.random.default_rng(5), 2, 1, 4096))
    want = cuda_sort.sort_blocks(lanes, 2, 1024)
    buf = torch.stack(lanes)
    got = cuda_sort.sort_blocks_(buf, 2, 1024)
    assert got[0].data_ptr() == buf.data_ptr()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sort.sort_blocks_(torch.stack(lanes, 1).t(), 2, 1024)


def _run_view(seed: int, N: int, W: int):
    """A sorted W-lane run view with duplicates and a sentinel tail, from
    JAX count_sorted (the same input for both packages)."""
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 1 << 12, size=N, dtype=np.uint32)]
    keys += [rng.integers(0, 4, size=N, dtype=np.uint32) for _ in range(W - 1)]
    valid = rng.random(N) > 0.1
    sc = jcs.count_sorted(jnp.stack([jnp.asarray(k) for k in keys], 1), None,
                          jnp.asarray(valid), sentinel_safe=True)
    words = np.asarray(sc.words)
    return ([words[:, w] for w in range(W)], np.array(sc.counts), np.array(sc.is_uniq))


@pytest.mark.parametrize("N,W,block,out_cap", [
    (4096, 2, 1024, 512),  # overflow past out_cap
    (4096, 2, 1024, 8192),
    (3000, 3, 1024, 4000),  # N not a block multiple
    (5000, 1, 1 << 15, 100),  # block shrinks to the input
])
def test_compact_block_sort_matches_jax_and_default(N, W, block, out_cap):
    cols, counts, is_uniq = _run_view(N + W, N, W)
    jargs = (tuple(jnp.asarray(c) for c in cols), jnp.asarray(counts), jnp.asarray(is_uniq),
             out_cap)
    if N % block == 0:
        want = jcs.compact_marked(*jargs, block=block, pallas=True, pallas_interpret=True)
    else:
        want = jcs.compact_marked(*jargs, block=N)
    targs = (tuple(_t(c) for c in cols), _t(counts.astype(np.int32)),
             torch.from_numpy(is_uniq), out_cap)
    got = tcs.compact_marked(*targs, block=block, block_sort=True)
    plain = tcs.compact_marked(*targs)
    for g, p, w in zip(got[0], plain[0], want[0]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
        assert torch.equal(g, p)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert torch.equal(got[1], plain[1])
    assert int(got[2]) == int(plain[2]) == int(want[2])
    assert int(got[3]) == int(plain[3]) == int(want[3])
    assert (int(got[3]) > 0) == (int(want[2]) > out_cap)


def test_block_sort_opt_in_reads_the_jax_switch(monkeypatch):
    monkeypatch.delenv("FASTKMER_PALLAS_COMPACT", raising=False)
    assert not tcs.block_sort_opt_in() and not jcs.pallas_compact_opt_in()
    monkeypatch.setenv("FASTKMER_PALLAS_COMPACT", "1")
    assert tcs.block_sort_opt_in() and jcs.pallas_compact_opt_in()
