"""The designs of the block sort (kernel C) and the staged extract kernels
(count mode A, full mode B) of fastkmer_tpu_torch, checked on the CPU.  No
kernel runs here; their index arithmetic does.

* ``cuda_extract.extract_count_twin`` (the staged count-mode kernel: codes
  with their halo, 16-mers packed at every position, prefix counts of
  invalid codes, the O(W) word pick, at a small tile) against the Pallas
  count-mode kernel ``extract_pallas_sentinel(interpret=True)`` for
  k % 16 != 0, against ``pipeline._batch_extract_keys_flagged`` with the
  flag lane for k % 16 == 0, and against the jnp route
  ``pipeline._batch_extract_keys`` past the Pallas kernel's k <= 256;
  bit-equality.  ``count_route`` sends to the byte route exactly the k
  whose staged block would not fit.
* ``cuda_extract.extract_full_twin`` (the same staged tile, the van Herk
  window minimum, at a small tile) against
  ``fastkmer_tpu.ops.extract.extract`` and the Pallas full-mode kernel ``extract_pallas(interpret=True)``: ``valid`` equal
  everywhere, words, sigs and bins equal where valid, bins in [0, B).
  Integer outputs, so the tolerance is bit-equality.
* The bitonic network in numpy, stage by stage as ``cuda_sort.stage_plan``
  places it (shuffle stages with both threads of a pair deciding by one
  strict comparison, the others with one owner per pair, which may swap a
  tie in a descending pair), each stage's pair checked to lie where
  the plan says (one thread, one warp, one CTA, two CTAs of the cluster),
  on tie-heavy and all-equal blocks: every block sorted, its rows kept as
  a multiset.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from fastkmer_tpu import pipeline as jpipe  # noqa: E402
from fastkmer_tpu.ops import extract as jex  # noqa: E402
from fastkmer_tpu.ops import pallas_extract as pex  # noqa: E402
from fastkmer_tpu_torch.ops import cuda_extract, cuda_sort  # noqa: E402

TILE = 16  # window starts per block of the twin (the kernel's is 1024)


def _codes(seed: int, R: int, L: int, k: int) -> np.ndarray:
    """~4% N, an all-T row, and Ns on the twin's tile boundaries: the last
    start of a tile, the first of the next, and the end of its halo."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
    codes[rng.random((R, L)) < 0.04] = 4
    codes[0] = 3
    for q in range(1, L // TILE + 1):
        for p in (q * TILE - 1, q * TILE, q * TILE + k - 1):
            if p < L and R > 1:
                codes[1, p] = 4
    return codes


def _check_twin(codes: np.ndarray, k: int, m: int, B: int = 97) -> None:
    got = cuda_extract.extract_full_twin(torch.from_numpy(codes), k, m, B, tile=TILE)
    want = jax.jit(lambda c: jex.extract(c, k, m, B))(jnp.asarray(codes))
    pallas = pex.extract_pallas(jnp.asarray(codes), k, m, B, block_rows=codes.shape[0],
                                interpret=True)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(pallas.valid))
    for ref in (want, pallas):
        np.testing.assert_array_equal(got.words.numpy().view(np.uint32)[v],
                                      np.asarray(ref.words)[v])
        np.testing.assert_array_equal(got.sigs.numpy().view(np.uint32)[v],
                                      np.asarray(ref.sigs)[v])
        np.testing.assert_array_equal(got.bins.numpy()[v], np.asarray(ref.bins)[v])
    bins = got.bins.numpy()
    assert ((bins >= 0) & (bins < B)).all()
    assert got.words.dtype == got.bins.dtype == got.sigs.dtype == torch.int32
    assert got.valid.dtype == torch.bool


@pytest.mark.parametrize("k,m", [(5, 4), (16, 9), (17, 10), (28, 10), (32, 9), (33, 12),
                                 (155, 14), (256, 15), (11, 10)])
def test_extract_twin_matches_jax_and_pallas(k, m):
    _check_twin(_codes(k, 3, k + 3 * TILE + 5, k), k, m)


@pytest.mark.parametrize("k,m", [(28, 10), (155, 14)])
def test_extract_twin_rows_of_exactly_k(k, m):
    _check_twin(_codes(k + 1, 4, k, k), k, m)


# --- kernel A: the staged count-mode twin -------------------------------------


def _check_count_twin(codes: np.ndarray, k: int) -> None:
    """The twin at TILE starts a block against the JAX package's count-mode
    keys: the Pallas kernel in interpret mode (k % 16 != 0, k <= 256), the
    flagged jnp keys (k % 16 == 0), the jnp route past k = 256."""
    c = jnp.asarray(codes)
    if k % 16 == 0:
        want = jpipe._batch_extract_keys_flagged(c, k, 9, 97)
    elif k <= 256:
        want = pex.extract_pallas_sentinel(c, k, 4, 97, block_rows=codes.shape[0],
                                           interpret=True)
    else:
        want = jpipe._batch_extract_keys(c, k, 14, 97, use_pallas=False)
    got = cuda_extract.extract_count_twin(torch.from_numpy(codes), k, flag_lane=k % 16 == 0,
                                          tile=TILE)
    assert len(got) == len(want) == -(-k // 16) + (k % 16 == 0)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (codes.shape[0] * (codes.shape[1] - k + 1),)
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))


@pytest.mark.parametrize("k", [5, 13, 17, 28, 33, 55, 155, 255, 16, 32, 64, 256, 301])
def test_count_twin_matches_jax(k):
    _check_count_twin(_codes(k + 2, 3, k + 3 * TILE + 5, k), k)


@pytest.mark.parametrize("k", [28, 155])
def test_count_twin_rows_of_exactly_k(k):
    _check_count_twin(_codes(k + 3, 4, k, k), k)


def test_count_route_by_shared_memory():
    top = cuda_extract._MAX_K_STAGED
    size, tile = cuda_extract._staged_bytes, cuda_extract.FULL_TILE
    assert size(tile, top) <= cuda_sort.SMEM_BYTES < size(tile, top + 1)
    # the staged launch opts in past 48 KB from k = 2754 on
    assert size(tile, 2753) <= 48 * 1024 < size(tile, 2754)
    # k <= 32 takes 2048 starts a block, 27 KB at most
    assert size(cuda_extract.count_tile(32), 32) <= 48 * 1024
    assert [cuda_extract.count_route(k) for k in (1, 256, top, top + 1, cuda_extract._MAX_K)] == [
        "staged", "staged", "staged", "bytes", "bytes"]


# --- kernel C: the network as the plan places it ------------------------------


def _less(a: np.ndarray, b: np.ndarray, keys: int) -> np.ndarray:
    """Rows a < b over the first ``keys`` lanes, two lanes as one uint64."""
    lt = np.zeros(a.shape[0], bool)
    eq = np.ones(a.shape[0], bool)
    for p in range(0, keys, 2):
        x = a[:, p].astype(np.uint64) << np.uint64(32)
        y = b[:, p].astype(np.uint64) << np.uint64(32)
        if p + 1 < keys:
            x |= a[:, p + 1].astype(np.uint64)
            y |= b[:, p + 1].astype(np.uint64)
        lt |= eq & (x < y)
        eq &= x == y
    return lt


def _kind(plan, klev: int, s: int, where: str) -> int:
    """Rank of a stage inside its klev: cluster or device, shared, registers
    in mapping X, shuffle, registers in mapping Y."""
    x = where == "registers" and s >= 32 and klev > 32 * plan.rows_per_thread
    return {"cluster": 0, "device": 0, "shared": 1, "shuffle": 3}.get(where, 2 if x else 4)


def _where_ok(plan, klev: int, s: int, i: np.ndarray, j: np.ndarray, where: str) -> bool:
    """Rows i and j = i ^ s lie where the plan runs their stage: one thread
    (lane ln holds rows ln·R + r in mapping Y, ln + 32 r in mapping X), one
    warp's chunk, one CTA, two CTAs of the cluster."""
    rc = plan.rows_per_cta
    same_cta = (i // rc) == (j // rc)
    if where == "cluster":  # a pass reaching other CTAs: rows in the cluster's block
        return bool((((i // rc) < plan.cluster) & ((j // rc) < plan.cluster)).all())
    if where in ("shared", "device"):
        return bool(same_cta.all()) if where == "shared" else bool((~same_cta).all())
    R = plan.rows_per_thread
    C = 32 * R
    same_chunk = (i // C) == (j // C)
    if where == "registers" and _kind(plan, klev, s, where) == 2:  # mapping X
        return bool((same_chunk & (i % 32 == j % 32)).all())
    if where == "registers":  # mapping Y: one lane
        return bool((same_chunk & ((i % C) // R == (j % C) // R)).all())
    return bool((same_chunk & (i % R == j % R)).all())  # shuffle, mapping Y


def _check_passes(plan, lanes: int) -> None:
    """The shared-memory stages of each klev come in passes of consecutive
    halving strides, at most ``pass_strides`` each, the pass reaching
    other CTAs exactly when its largest stride does."""
    if plan.route != "cluster":
        return
    ns = cuda_sort.pass_strides(lanes)
    by_stage = {(kl, s): w for kl, s, w in plan.stages}
    covered = set()
    for kl, strides in plan.passes:
        assert 1 <= len(strides) <= ns and all(a == 2 * b for a, b in zip(strides, strides[1:]))
        want = "cluster" if strides[0] >= plan.rows_per_cta else "shared"
        assert all(by_stage[kl, s] == want for s in strides)
        covered |= {(kl, s) for s in strides}
    assert covered == {k for k, w in by_stage.items() if w in ("shared", "cluster")}


def _run_network(rows: np.ndarray, keys: int, block: int, plan) -> np.ndarray:
    _check_passes(plan, rows.shape[1])
    rows = rows.copy()
    i = np.arange(rows.shape[0])
    b = i % block  # block index of a row
    last = None
    for klev, s, where in plan.stages:
        # within one klev the stages run cluster, shared, X, shuffle, Y
        kind = _kind(plan, klev, s, where)
        assert last is None or last[0] != klev or last[1] <= kind
        last = (klev, kind)
        asc = (b & klev) == 0
        if where == "shuffle":  # both rows of a pair decide, each keeps its own on a tie
            part = i ^ s
            lower = (b & s) == 0
            assert _where_ok(plan, klev, s, i, part, where)
            other = rows[part]  # the kernel's rule: lower == asc ? o < own : own < o
            swap = np.where(lower == asc, _less(other, rows, keys), _less(rows, other, keys))
            rows = np.where(swap[:, None], other, rows)
        else:  # one owner per pair
            lo = i[(b & s) == 0]
            hi = lo | s
            assert _where_ok(plan, klev, s, lo % block, hi % block, where)
            # the kernel's rule: hi < lo, flipped for a descending pair
            swap = _less(rows[hi], rows[lo], keys) != ~asc[lo]
            x, y = rows[lo[swap]].copy(), rows[hi[swap]].copy()
            rows[lo[swap]], rows[hi[swap]] = y, x
    return rows


@pytest.mark.parametrize("lanes,keys,block,route", [
    (3, 2, 1 << 15, "cluster"),   # the compaction's shape: 4 CTAs
    (4, 3, 1 << 15, "cluster"),   # 8 CTAs, 8 rows a thread
    (14, 13, 1 << 15, "cluster"),  # 8 CTAs, 4 rows a thread
    (2, 1, 1024, "cluster"),      # one CTA
    (15, 14, 1 << 15, "tiled"),   # would need 16 CTAs
])
@pytest.mark.parametrize("data", ["ties", "equal"])
def test_network_as_planned_sorts_and_keeps_rows(lanes, keys, block, route, data):
    plan = cuda_sort.stage_plan(lanes, block)
    assert plan.route == route
    rng = np.random.default_rng(lanes * 100 + keys)
    N = 2 * block
    rows = rng.integers(0, 1 << 32, size=(N, lanes), dtype=np.uint64).astype(np.uint32)
    if data == "ties":
        k = rows[:, :keys]
        tie = rng.random((N, keys)) < 0.7
        k[tie] = rng.integers(0, 3, size=int(tie.sum()))
        k[rng.random(N) < 0.3] = 0xFFFFFFFF  # sentinel rows
    else:
        rows[:, :keys] = 7
    got = _run_network(rows, keys, block, plan)
    for blk in range(N // block):
        sl = slice(blk * block, (blk + 1) * block)
        g = got[sl]
        assert not _less(g[1:], g[:-1], keys).any()  # ascending
        want = rows[sl]
        np.testing.assert_array_equal(g[np.lexsort(g.T[::-1])], want[np.lexsort(want.T[::-1])])


@pytest.mark.parametrize("lanes,block,route,cluster,touch", [
    (3, 1 << 15, "cluster", 4, 21),
    (4, 1 << 15, "cluster", 8, 28),
    (14, 1 << 15, "cluster", 8, 36),
    (2, 1 << 13, "cluster", 1, 10),
    (3, 1 << 18, "tiled", 0, 171),
])
def test_stage_plan_routes_by_shape(lanes, block, route, cluster, touch):
    plan = cuda_sort.stage_plan(lanes, block)
    assert (plan.route, plan.cluster) == (route, cluster)
    n = block.bit_length() - 1
    assert len(plan.stages) == n * (n + 1) // 2
    # stages that touch shared or device memory (the rest stay in registers)
    assert sum(w in ("shared", "cluster", "device") for _, _, w in plan.stages) == touch
    if route == "cluster":
        assert lanes * plan.rows_per_cta * 4 <= cuda_sort.SMEM_BYTES
        assert plan.rows_per_thread * lanes <= 64  # registers of rows a thread
    with pytest.raises(ValueError):
        cuda_sort.stage_plan(lanes, 1536)
