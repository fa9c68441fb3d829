"""fastkmer_tpu_torch.parallel.exchange (single-process mesh of n CPU
shards) vs fastkmer_tpu.parallel.exchange on a JAX mesh of n virtual CPU
devices, n in {2, 3, 8}: routing, per-shard tables after
``compact_shard_counts`` for k-mer and super-k-mer transport, the dropped
count at an undersized cap, the LPT pre-pass histogram and the exchange
byte formula.  Integer outputs, so the tolerance is bit-equality."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fastkmer_tpu.parallel import exchange as jx  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange as tx  # noqa: E402

from .test_torch_extract import make_codes  # noqa: E402

B = 64
R, L = 24, 200  # R divides by every mesh size below


def jmesh(n: int):
    return jax.make_mesh((n,), (jx.AXIS,), devices=jax.devices("cpu")[:n])


def codes_for(k: int) -> np.ndarray:
    codes = make_codes(k + 101, R, L, k)
    codes[5] = np.tile(np.array([0, 1, 2, 3, 3, 1], np.uint8), L // 6 + 1)[:L]  # long runs
    return codes


def owner_map(n: int) -> np.ndarray:
    """A non-hash placement, as the LPT pre-pass gives."""
    return np.random.default_rng(n).integers(0, n, B).astype(np.int32)


def assert_parts_equal(tparts, jparts):
    assert len(tparts) == len(jparts)
    for (tw, tc, tb), (jw, jc, jb) in zip(tparts, jparts):
        np.testing.assert_array_equal(tw, np.asarray(jw))
        np.testing.assert_array_equal(tc, np.asarray(jc))
        np.testing.assert_array_equal(tb, np.asarray(jb))
        assert tw.dtype == np.uint32 and tc.dtype == np.int64 and tb.dtype == np.int32


@pytest.mark.parametrize("n,cap", [(2, 300), (3, 40), (8, 7), (8, 2000)])
def test_route_by_owner(n, cap):
    rng = np.random.default_rng(n * cap)
    N = 1000
    owner = rng.integers(0, n, N).astype(np.int32)
    valid = rng.random(N) < 0.8
    cols = (rng.integers(0, 1 << 31, N).astype(np.int32), np.arange(N, dtype=np.int32))
    fills = (-1, 0)
    jr, jok, jd = jx.route_by_owner(jnp.asarray(owner), jnp.asarray(valid),
                                    tuple(jnp.asarray(c) for c in cols), n, cap,
                                    fills=tuple(jnp.int32(f) for f in fills))
    tr, tok, td = tx.route_by_owner(torch.from_numpy(owner), torch.from_numpy(valid),
                                    tuple(torch.from_numpy(c) for c in cols), n, cap, fills=fills)
    over = np.maximum(np.bincount(owner[valid], minlength=n) - cap, 0).sum()
    assert int(td) == int(jd) == int(over)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok).astype(np.int32))
    for d in range(n):
        blk = slice(d * cap, (d + 1) * cap)
        ok = tok.numpy()[blk] == 1
        trows = sorted(zip(*(c.numpy()[blk][ok].tolist() for c in tr)))
        jrows = sorted(zip(*(np.asarray(c)[blk][ok].tolist() for c in jr)))
        if int(td) == 0:
            assert trows == jrows  # the same rows reach each destination
        else:  # which rows overflow is free; how many is not
            assert len(trows) == len(jrows)
        assert all(owner[i] == d and valid[i] for _, i in trows)
        for c, f in zip(tr, fills):  # unfilled slots hold the fill
            assert (c.numpy()[blk][~ok] == f).all()


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("k,m", [(28, 10), (32, 9)])
def test_build_distributed_count(n, k, m):
    codes = codes_for(k)
    own = owner_map(n)
    cap = (R // n) * (L - k + 1)  # worst case: nothing drops
    jsc = jx.build_distributed_count(jmesh(n), k, m, B, cap, own)(jx.shard_batch(jmesh(n), codes))
    tmesh = tx.make_mesh(n, "cpu")
    tsc = tx.build_distributed_count(tmesh, k, m, B, cap, own)(tx.shard_batch(tmesh, codes))
    assert int(tsc.dropped) == int(jsc.dropped) == 0
    assert_parts_equal(tx.compact_shard_counts(tsc), jx.compact_shard_counts(jsc))
    assert [int(v) for v in tsc.n_valid] == np.asarray(jsc.n_valid).tolist()
    chips = [c for c, _ in tx.compact_shard_counts(tsc, with_chips=True)]
    assert chips == list(range(n))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("k,m,smax", [(28, 10, 64), (32, 9, 48)])
def test_build_distributed_count_smer(n, k, m, smax):
    codes = codes_for(k)
    own = owner_map(n)
    cap = (R // n) * (L - k + 1) + 1
    jsc = jx.build_distributed_count_smer(jmesh(n), k, m, B, cap, smax, own)(
        jx.shard_batch(jmesh(n), codes))
    tmesh = tx.make_mesh(n, "cpu")
    tsc = tx.build_distributed_count_smer(tmesh, k, m, B, cap, smax, own)(
        tx.shard_batch(tmesh, codes))
    assert int(tsc.dropped) == int(jsc.dropped) == 0
    assert_parts_equal(tx.compact_shard_counts(tsc), jx.compact_shard_counts(jsc))


@pytest.mark.parametrize("smer", [False, True])
def test_dropped_at_undersized_cap(smer):
    n, k, m, cap = 3, 28, 10, 16
    codes = codes_for(k)
    own = owner_map(n)
    tmesh = tx.make_mesh(n, "cpu")
    if smer:
        jstep = jx.build_distributed_count_smer(jmesh(n), k, m, B, cap, 64, own)
        tstep = tx.build_distributed_count_smer(tmesh, k, m, B, cap, 64, own)
    else:
        jstep = jx.build_distributed_count(jmesh(n), k, m, B, cap, own)
        tstep = tx.build_distributed_count(tmesh, k, m, B, cap, own)
    jd = int(jstep(jx.shard_batch(jmesh(n), codes)).dropped)
    td = int(tstep(tx.shard_batch(tmesh, codes)).dropped)
    assert td == jd > 0


@pytest.mark.parametrize("n", [2, 3, 8])
def test_estimate_bin_sizes(n):
    k, m = 28, 10
    codes = codes_for(k)
    want = np.asarray(jx.estimate_bin_sizes(jmesh(n), k, m, B)(jx.shard_batch(jmesh(n), codes)))
    tmesh = tx.make_mesh(n, "cpu")
    got = tx.estimate_bin_sizes(tmesh, k, m, B)(tx.shard_batch(tmesh, codes))
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_exchange_bytes_per_step():
    for n in (1, 2, 3, 8):
        for cap in (1, 4096, 123457):
            for k in (13, 28, 31, 32, 55, 64):
                for smax in (None, 32, 64, 128):
                    assert tx.exchange_bytes_per_step(n, cap, k, smax) == \
                        jx.exchange_bytes_per_step(n, cap, k, smax)


def test_mesh_placement_and_shards():
    mesh = tx.make_mesh(3, "cpu")
    assert mesh.size == 3
    assert all(d.type == "cpu" for d in mesh.devices)
    codes = codes_for(28)
    shards = tx.shard_batch(mesh, codes)
    assert [s.shape for s in shards] == [(R // 3, L)] * 3
    np.testing.assert_array_equal(torch.cat(shards).numpy(), codes)
    with pytest.raises(ValueError, match="do not split"):
        tx.shard_batch(tx.make_mesh(5, "cpu"), codes)
    with pytest.raises(ValueError):
        tx.make_mesh(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tx.make_mesh(2, "cuda")
