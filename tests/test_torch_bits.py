"""fastkmer_tpu_torch.core.tbits vs the numpy (core.bits) and jax
(core.jbits) bit cores: exhaustive at m = 4, 5, 7, random up to m = 15.
Integer ops throughout, so the tolerance is bit-equality."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fastkmer_tpu.core import bits, jbits  # noqa: E402
from fastkmer_tpu_torch.core import tbits  # noqa: E402


def _t(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(v.astype(np.int64))


def _values(m: int) -> np.ndarray:
    if m in (4, 5, 7):
        return np.arange(4**m, dtype=np.uint32)
    rng = np.random.default_rng(m)
    return rng.integers(0, 4**m, size=20_000, dtype=np.uint32)


@pytest.mark.parametrize("m", [4, 5, 7, 9, 12, 15])
def test_mmer_ops_match_numpy_and_jax(m):
    v = _values(m)
    rc = tbits.rc_mmers(_t(v), m).numpy()
    np.testing.assert_array_equal(rc, bits.rc_mmers(v, m))
    np.testing.assert_array_equal(rc, np.asarray(jbits.rc_mmers(jnp.asarray(v), m)))
    ok = tbits.allowed_mask(_t(v), m).numpy()
    np.testing.assert_array_equal(ok, bits.allowed_mask(v, m))
    norm = tbits.norm_mmers(_t(v), m).numpy()
    np.testing.assert_array_equal(norm, np.asarray(jbits.norm_mmers(jnp.asarray(v), m)))
    if m <= 7:
        np.testing.assert_array_equal(norm, bits.fill_norm(m)[v])


@pytest.mark.parametrize("B", [1, 7, 512, 2000, 1 << 20])
def test_hash_to_bucket_full_uint32_range(B):
    rng = np.random.default_rng(B)
    s = rng.integers(0, 1 << 32, size=50_000, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    got = tbits.hash_to_bucket(_t(s), B)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), bits.hash_to_bucket(s, B))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbits.hash_to_bucket(jnp.asarray(s), B))
    )


def test_reverse16_and_int32_carrier():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, size=50_000, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 0xFFFFFFFF, 0x80000000]
    as_i32 = torch.from_numpy(x.view(np.int32))
    got = tbits.reverse16(as_i32).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbits.reverse16(jnp.asarray(x))))
    # the carrier round-trips the uint32 bit pattern
    np.testing.assert_array_equal(tbits.as_u32(as_i32).numpy(), x.astype(np.int64))
    np.testing.assert_array_equal(
        tbits.as_i32(tbits.as_u32(as_i32)).numpy().view(np.uint32), x
    )
