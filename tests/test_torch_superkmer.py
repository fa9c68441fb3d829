"""fastkmer_tpu_torch.ops.superkmer vs fastkmer_tpu.ops.superkmer on the
same numpy code batches (reads with Ns, runs longer than smax - k + 1, an
all-T row, rows shorter than a record).  Integer outputs, so the tolerance
is bit-equality."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fastkmer_tpu.ops import superkmer as jsk  # noqa: E402
from fastkmer_tpu_torch.ops import cuda_extract  # noqa: E402
from fastkmer_tpu_torch.ops import superkmer as tsk  # noqa: E402

from .test_torch_extract import make_codes  # noqa: E402

CASES = [(k, smax) for k in (13, 28, 32, 55) for smax in (32, 64, 128) if smax > k]
M = {13: 4, 28: 10, 32: 9, 55: 9}
B = 64


def batch(k: int, smax: int) -> np.ndarray:
    """make_codes rows plus a periodic row (one signature over hundreds of
    windows, so runs pass smax - k + 1 and are split)."""
    L = max(smax, k) + 180
    codes = make_codes(k * 7 + smax, 7, L, k)
    codes[3] = np.tile(np.array([0, 1, 2, 3, 3, 1], np.uint8), L // 6 + 1)[:L]
    return codes


@pytest.fixture(scope="module")
def grouped():
    """(k, smax) -> (codes, JAX (SuperKmers, Extracted)); one jit each."""
    out = {}
    for k, smax in CASES:
        codes = batch(k, smax)
        out[k, smax] = codes, jax.jit(
            lambda c, k=k, smax=smax: jsk.group(c, k, M[k], B, smax)
        )(jnp.asarray(codes))
    return out


@pytest.mark.parametrize("k,smax", CASES)
def test_group_matches_jax(grouped, k, smax):
    codes, (jk, _) = grouped[k, smax]
    tk, tex = tsk.group(torch.from_numpy(codes), k, M[k], B, smax)
    st = np.asarray(jk.is_start)
    np.testing.assert_array_equal(tk.is_start.numpy(), st)
    np.testing.assert_array_equal(tk.n_kmers.numpy(), np.asarray(jk.n_kmers))
    np.testing.assert_array_equal(tk.payload.numpy().view(np.uint32), np.asarray(jk.payload))
    np.testing.assert_array_equal(tk.bins.numpy()[st], np.asarray(jk.bins)[st])
    assert tk.payload.dtype == tk.n_kmers.dtype == tk.bins.dtype == torch.int32
    # split runs: some records are full, every k-mer is covered once
    cap = smax - k + 1
    assert (tk.n_kmers.numpy() == cap).any()
    assert int(tk.n_kmers.sum()) == int(tex.valid.sum())


@pytest.mark.parametrize("k,smax", CASES)
def test_group_takes_extract_full_output(grouped, k, smax):
    """The mesh passes the full-mode extractor's output through ``ex=``."""
    codes, (jk, _) = grouped[k, smax]
    t = torch.from_numpy(codes)
    tk, _ = tsk.group(t, k, M[k], B, smax, ex=cuda_extract.extract_full(t, k, M[k], B))
    np.testing.assert_array_equal(tk.n_kmers.numpy(), np.asarray(jk.n_kmers))


@pytest.mark.parametrize("k,smax", CASES)
def test_expand_matches_jax(grouped, k, smax):
    """Records as the owner receives them: the run starts, then unfilled
    slots (payload all-ones, n_kmers 0)."""
    _, (jk, _) = grouped[k, smax]
    st = np.asarray(jk.is_start)
    pay = np.concatenate([np.asarray(jk.payload)[st],
                          np.full((5, smax // 16), 0xFFFFFFFF, np.uint32)])
    nk = np.concatenate([np.asarray(jk.n_kmers)[st], np.zeros(5, np.int32)])
    bins = np.arange(nk.size, dtype=np.int32) % B
    jw, jv, jb = jsk.expand(jnp.asarray(pay), jnp.asarray(nk), jnp.asarray(bins), k, smax)
    tw, tv, tb = tsk.expand(torch.from_numpy(pay.view(np.int32)), torch.from_numpy(nk),
                            torch.from_numpy(bins), k, smax)
    assert tw.shape == (nk.size, smax - k + 1, -(-k // 16)) and tw.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_payload_words_and_bad_smax():
    assert tsk.payload_words(64) == jsk.payload_words(64) == 4
    with pytest.raises(ValueError, match="multiple of 16"):
        tsk.payload_words(40)
    with pytest.raises(ValueError, match="holds no"):
        tsk.group(torch.zeros((2, 80), dtype=torch.uint8), 55, 9, B, 32)
