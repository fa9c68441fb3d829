"""Stage-1 extract in fastkmer_tpu_torch vs fastkmer_tpu on the same numpy
inputs (reads with Ns, reads shorter than k + 16, all-T reads).  Integer
outputs, so the tolerance is bit-equality.

* the plain ``extract`` vs ``fastkmer_tpu.ops.extract.extract``;
* ``extract_sentinel_reference`` vs the Pallas count-mode kernel
  (``extract_pallas_sentinel``) run in interpret mode;
* the flag lane vs ``pipeline._batch_extract_keys_flagged`` (k % 16 == 0);
* the plain ``extract`` (full mode's plain version) vs the Pallas full-mode
  kernel (``extract_pallas``) run in interpret mode, where valid;
* ``extract_full`` on a CPU tensor: the plain result, no launch.

The CUDA kernels themselves are held against their plain versions on the
card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fastkmer_tpu.core import bits  # noqa: E402
from fastkmer_tpu_torch.ops import cuda_extract  # noqa: E402
from fastkmer_tpu_torch.ops import extract as tex  # noqa: E402
from fastkmer_tpu_torch.ops import windows as twin  # noqa: E402


def make_codes(seed: int, R: int, L: int, k: int) -> np.ndarray:
    """[R, L] codes: random reads with ~3% N, one all-T read, one read
    shorter than k + 16, one read of exactly k bases, padding with code 4."""
    rng = np.random.default_rng(seed)
    codes = np.full((R, L), bits.INVALID_CODE, np.uint8)
    for r in range(R):
        n = int(rng.integers(max(1, L // 3), L + 1))
        codes[r, :n] = rng.integers(0, 4, n)
        codes[r, :n][rng.random(n) < 0.03] = bits.INVALID_CODE
    codes[0, :] = 3  # all-T: canonical is all-A
    codes[1, :] = bits.INVALID_CODE
    codes[1, : min(L, k + 9)] = rng.integers(0, 4, min(L, k + 9))
    codes[2, :] = bits.INVALID_CODE
    codes[2, :k] = rng.integers(0, 4, k)
    return codes


@pytest.mark.parametrize("k", [5, 15, 16, 17, 28, 31, 32, 33, 55, 64, 97, 128, 129, 155, 201])
def test_plain_extract_matches_jax(k):
    from fastkmer_tpu.ops import extract as jex

    m = min(15, max(4, k // 3)) if k > 5 else 4
    B = 97
    L = k + 40
    codes = make_codes(k, 6, L, k)
    a = jax.jit(lambda c: jex.extract(c, k, m, B))(jnp.asarray(codes))
    b = tex.extract(torch.from_numpy(codes), k, m, B)
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    np.testing.assert_array_equal(b.words.numpy().view(np.uint32), np.asarray(a.words))
    np.testing.assert_array_equal(b.sigs.numpy().view(np.uint32), np.asarray(a.sigs))
    np.testing.assert_array_equal(b.bins.numpy(), np.asarray(a.bins))
    assert b.valid.any()


def test_windows_match_jax():
    from fastkmer_tpu.ops import windows as jwin

    rng = np.random.default_rng(1)
    c2 = rng.integers(0, 4, size=(3, 70)).astype(np.uint32)
    for length in (1, 3, 7, 10, 16):
        np.testing.assert_array_equal(
            twin.rolling_pack(torch.from_numpy(c2.astype(np.int64)), length).numpy(),
            np.asarray(jwin.rolling_pack(jnp.asarray(c2), length)),
        )
    a = rng.integers(0, 1 << 31, size=(2, 64)).astype(np.uint32)
    mask = rng.random((2, 64)) < 0.1
    for w in (1, 2, 5, 8, 19, 64):
        np.testing.assert_array_equal(
            twin.window_min(torch.from_numpy(a.astype(np.int64)), w).numpy(),
            np.asarray(jwin.window_min(jnp.asarray(a), w)),
        )
        np.testing.assert_array_equal(
            twin.window_any(torch.from_numpy(mask), w).numpy(),
            np.asarray(jwin.window_any(jnp.asarray(mask), w)),
        )


@pytest.mark.parametrize("k,m", [(28, 10), (13, 4), (45, 8), (97, 13)])
def test_sentinel_reference_matches_pallas_interpret(k, m):
    from fastkmer_tpu.ops import pallas_extract as pex

    B = 64
    L = 80 if k <= 64 else 160
    codes = make_codes(k + 1, 10, L, k)
    ref = pex.extract_pallas_sentinel(jnp.asarray(codes), k, m, B, block_rows=4,
                                      interpret=True)
    before = cuda_extract.LAUNCHES
    got = cuda_extract.extract_sentinel(torch.from_numpy(codes), k, m, B)
    assert cuda_extract.LAUNCHES == before  # a CPU tensor never launches
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.shape == (10 * (L - k + 1),)
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(r))


@pytest.mark.parametrize("k,m", [(32, 9), (64, 11)])
def test_flag_lane_matches_jax_flagged_keys(k, m):
    from fastkmer_tpu import pipeline as jpipe

    B = 64
    L = k + 50
    codes = make_codes(k, 8, L, k)
    ref = jpipe._batch_extract_keys_flagged(jnp.asarray(codes), k, m, B)
    got = cuda_extract.extract_sentinel(torch.from_numpy(codes), k, m, B, flag_lane=True)
    assert len(got) == len(ref) == k // 16 + 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(r))
    # the all-T row's canonical all-A k-mer is a valid row, apart from the
    # sentinel only by its flag lane
    assert (got[-1][: L - k + 1] == 0).all()


def test_wrapper_validates_inputs():
    codes = torch.zeros((2, 40), dtype=torch.uint8)
    with pytest.raises(TypeError):
        cuda_extract.extract_sentinel(codes.to(torch.int32), 28, 10, 64)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_extract.extract_sentinel(torch.zeros((40, 2), dtype=torch.uint8).t(), 28, 10, 64)
    with pytest.raises(ValueError, match="flag_lane"):
        cuda_extract.extract_sentinel(codes, 32, 10, 64)
    with pytest.raises(ValueError, match="read_len"):
        cuda_extract.extract_sentinel(codes, 41, 10, 64)


FULL_CASES = [(13, 4), (28, 10), (31, 8), (32, 9), (55, 9), (97, 13)]


@pytest.mark.parametrize("k,m", FULL_CASES)
def test_plain_extract_matches_pallas_full_interpret(k, m):
    from fastkmer_tpu.ops import pallas_extract as pex

    B = 64
    L = 96 if k <= 64 else 160
    codes = make_codes(k + 7, 12, L, k)
    ref = pex.extract_pallas(jnp.asarray(codes), k, m, B, block_rows=4, interpret=True)
    got = tex.extract(torch.from_numpy(codes), k, m, B)
    va = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), va)
    np.testing.assert_array_equal(got.words.numpy().view(np.uint32)[va], np.asarray(ref.words)[va])
    np.testing.assert_array_equal(got.sigs.numpy().view(np.uint32)[va], np.asarray(ref.sigs)[va])
    np.testing.assert_array_equal(got.bins.numpy()[va], np.asarray(ref.bins)[va])
    bins = got.bins.numpy()
    assert ((bins >= 0) & (bins < B)).all() and va.any() and not va.all()


@pytest.mark.parametrize("k,m", FULL_CASES)
def test_extract_full_on_cpu_is_the_plain_version(k, m):
    R, L, B = 5, k + 30, 97
    codes = torch.from_numpy(make_codes(k, R, L, k))
    before = cuda_extract.FULL_LAUNCHES
    got = cuda_extract.extract_full(codes, k, m, B)
    assert cuda_extract.FULL_LAUNCHES == before  # a CPU tensor never launches
    want = tex.extract(codes, k, m, B)
    n, W = R * (L - k + 1), -(-k // 16)
    assert got.words.shape == (n, W) and got.words.dtype == torch.int32
    for f in ("bins", "sigs"):
        assert getattr(got, f).shape == (n,) and getattr(got, f).dtype == torch.int32
    assert got.valid.shape == (n,) and got.valid.dtype == torch.bool
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_extract_full_validates_inputs():
    codes = torch.zeros((2, 300), dtype=torch.uint8)
    with pytest.raises(ValueError, match="k=257"):
        cuda_extract.extract_full(codes, 257, 10, 64)
    with pytest.raises(ValueError, match="m=16"):
        cuda_extract.extract_full(codes, 28, 16, 64)
    with pytest.raises(ValueError, match="m=28"):
        cuda_extract.extract_full(codes, 28, 28, 64)
    with pytest.raises(ValueError, match="B=0"):
        cuda_extract.extract_full(codes, 28, 10, 0)
    with pytest.raises(TypeError):
        cuda_extract.extract_full(codes.to(torch.int32), 28, 10, 64)
