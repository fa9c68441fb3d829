"""The HT engine's counting core, ``fastkmer_tpu_torch.ops.count_hash``,
against ``fastkmer_tpu.ops.count_hash`` on the CPU: ``fingerprint``
bit-exact for W = 1 to 5 words, ``count_hashed``'s unique rows, counts and
instance total, the murmur multiplies' int64 wraparound, and a collision
forced by a constant fingerprint, which both packages report and the
port's single-device and mesh jobs raise as ``FingerprintCollision``.
Integer outputs, so the tolerance is bit-equality."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fastkmer_tpu.core.bits import num_words  # noqa: E402
from fastkmer_tpu.ops import count_hash as jch  # noqa: E402
from fastkmer_tpu_torch.config import JobConfig  # noqa: E402
from fastkmer_tpu_torch import pipeline as tpipe  # noqa: E402
from fastkmer_tpu_torch.core.tbits import M32  # noqa: E402
from fastkmer_tpu_torch.ops import count_hash as tch  # noqa: E402
from fastkmer_tpu_torch.parallel import driver as tdriver  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange as tx  # noqa: E402

from .test_pipeline_e2e import write_fasta  # noqa: E402
from .test_torch_pipeline import mixed_reads  # noqa: E402

KS = [13, 28, 40, 64, 75]  # W = 1, 2, 3, 4, 5


def _words(seed: int, k: int, n: int = 4000) -> np.ndarray:
    """[n, W] packed k-mer words (pad bits zero), with all-zero and
    all-ones (where a k-mer can be all T) rows and many repeated rows."""
    rng = np.random.default_rng(seed)
    W = num_words(k)
    words = rng.integers(0, 1 << 32, size=(n // 4, W), dtype=np.uint64).astype(np.uint32)
    words = words[rng.integers(0, n // 4, size=n)]  # each row about 4 times
    words[:7] = 0
    words[7:13] = 0xFFFFFFFF
    words[13:17, 0] = 0xFFFFFFFF
    if k % 16:
        words[:, W - 1] &= np.uint32((0xFFFFFFFF << (32 - 2 * (k % 16))) & M32)
    return words


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("k", KS)
def test_fingerprint_matches_jax(k):
    words = _words(k, k)
    jhi, jlo = jch.fingerprint(jnp.asarray(words))
    thi, tlo = tch.fingerprint(_t(words))
    assert thi.dtype == tlo.dtype == torch.int32
    np.testing.assert_array_equal(thi.numpy().view(np.uint32), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy().view(np.uint32), np.asarray(jlo))


def test_murmur_multiplies_wrap_like_uint32():
    """The int64 products of ``_mix32`` and ``fingerprint`` overflow before
    the mask; the low 32 bits must still be uint32 arithmetic's."""
    x = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0xCC9E2D51, 0x27D4EB2F):
        got = (torch.from_numpy(x.astype(np.int64)) * c) & M32
        np.testing.assert_array_equal(got.numpy(), (x * np.uint64(c)) & np.uint64(M32))
    want = np.asarray(jch._mix32(jnp.asarray(x.astype(np.uint32))))
    np.testing.assert_array_equal(tch._mix32(torch.from_numpy(x.astype(np.int64))).numpy(), want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("weighted", [False, True])
def test_count_hashed_matches_jax(k, weighted):
    """Unique marks, counts and words at the unique rows in the same order,
    and the instance total; invalid rows' words are free (ROADMAP §3)."""
    words = _words(100 + k, k)
    rng = np.random.default_rng(k)
    valid = rng.random(words.shape[0]) < 0.9
    valid[7:13] = True  # the all-ones rows are real k-mers here
    wts = rng.integers(0, 50, size=words.shape[0]).astype(np.int32) if weighted else None
    jsc, jcoll = jch.count_hashed(jnp.asarray(words), None, jnp.asarray(valid),
                                  None if wts is None else jnp.asarray(wts))
    tsc, tcoll = tch.count_hashed(_t(words), None, torch.from_numpy(valid),
                                  None if wts is None else torch.from_numpy(wts))
    ju = np.asarray(jsc.is_uniq)
    np.testing.assert_array_equal(tsc.is_uniq.numpy(), ju)
    np.testing.assert_array_equal(tsc.counts.numpy()[ju], np.asarray(jsc.counts)[ju])
    np.testing.assert_array_equal(tsc.words.numpy().view(np.uint32)[ju],
                                  np.asarray(jsc.words)[ju])
    assert int(tsc.n_valid) == int(jsc.n_valid) > 0
    assert not bool(tcoll) and not bool(jcoll)
    # the unique rows in k-mer order are the sort engine's table
    uw, uc = tch.unique_in_kmer_order(tsc)
    want = np.unique(words[valid], axis=0)
    np.testing.assert_array_equal(uw.numpy().view(np.uint32), want)
    assert int(uc.sum()) == int(tsc.n_valid)


@pytest.mark.parametrize("k", [28, 40])
def test_forced_collision_is_reported_by_both(monkeypatch, k):
    """A constant fingerprint puts distinct k-mers in one run: both
    packages' count_hashed report the collision."""
    words = _words(7, k, 64)
    valid = np.ones(64, bool)

    def jconst(w):
        return jnp.zeros(w.shape[0], jnp.uint32), jnp.zeros(w.shape[0], jnp.uint32)

    def tconst(w):
        z = torch.zeros(w.shape[0], dtype=torch.int32)
        return z, z

    monkeypatch.setattr(jch, "fingerprint", jconst)
    monkeypatch.setattr(tch, "fingerprint", tconst)
    _, jcoll = jch.count_hashed(jnp.asarray(words), None, jnp.asarray(valid))
    _, tcoll = tch.count_hashed(_t(words), None, torch.from_numpy(valid))
    assert bool(jcoll) and bool(tcoll)


@pytest.mark.parametrize("mesh", [False, True])
def test_forced_collision_raises_in_the_jobs(tmp_path, monkeypatch, mesh):
    """The single-device job and the per-batch mesh job read the collision
    flag once at the end and raise FingerprintCollision, writing nothing."""
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, mixed_reads(3, n=20))
    cfg = JobConfig(dataset=fa, output_directory=str(tmp_path) + "/", prefix="c_", k=40,
                    m=8, max_b=32, reads_per_batch=8, read_len=256, use_ht=True)
    monkeypatch.setattr(tch, "fingerprint", lambda w: (
        torch.zeros(w.shape[0], dtype=torch.int32),) * 2)
    with pytest.raises(tch.FingerprintCollision):
        if mesh:
            tdriver.execute_job_distributed(cfg, tx.make_mesh(2, "cpu"), verbose=False)
        else:
            tpipe.execute_job(cfg, verbose=False, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == ["in.fa"]
