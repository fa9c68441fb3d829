"""Card tests of fastkmer_tpu_torch, marked ``cuda``; each skips without a
CUDA device.  The CUDA extract kernels (count and full mode) and the block
sort kernel are held against their plain torch versions (bit-equality,
where valid for full mode's words and sigs; keys bit-equal and row
multisets equal per block for the sort), and the count job and 2-shard
mesh jobs (per batch and streaming, with and without the block-sort
compaction) on cuda against the same jobs on the CPU.  No jax is needed, so a machine with a
card and no jax runs them without the jax-importing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fastkmer_tpu_torch import pipeline  # noqa: E402
from fastkmer_tpu_torch.config import JobConfig  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as batching  # noqa: E402
from fastkmer_tpu_torch.ops import cuda_extract, cuda_sort, extract  # noqa: E402
from fastkmer_tpu_torch.parallel import driver, exchange  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(seed: int, R: int, L: int, k: int) -> np.ndarray:
    """~2% N, an all-T row, a row of exactly k bases, a ragged tail."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
    codes[rng.random((R, L)) < 0.02] = 4
    codes[0] = 3
    codes[1:2, k:] = 4  # slices: rows past R are simply absent
    codes[2:3, L - k // 2 :] = 4
    return codes


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,flag", [(28, 10, False), (13, 4, False), (31, 8, False),
                                      (55, 9, False), (155, 14, False),
                                      (32, 10, True), (64, 11, True)])
def test_kernel_matches_plain(cuda, k, m, flag):
    for R, L in ((64, 1024), (3, k + 5), (1, k)):
        codes = torch.from_numpy(_codes(k + R, R, L, k)).to(cuda)
        before = cuda_extract.LAUNCHES
        got = cuda_extract.extract_sentinel(codes, k, m, 64, flag_lane=flag)
        torch.cuda.synchronize()
        assert cuda_extract.LAUNCHES == before + 1
        ref = cuda_extract.extract_sentinel_reference(codes, k, m, 64, flag_lane=flag)
        assert len(got) == len(ref) == -(-k // 16) + int(flag)
        for g, r in zip(got, ref):
            assert g.is_cuda and g.dtype == torch.int32 and g.shape == (R * (L - k + 1),)
            assert torch.equal(g, r)


def _write_fasta(path: str, seed: int) -> None:
    """Reads from both strands of a 4 kbp genome (duplication-heavy, so the
    adaptive pre-dedup engages) plus distinct reads with Ns."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 4096)
    with open(path, "w") as f:
        for i in range(600):
            s = int(rng.integers(0, 4096 - 200))
            read = genome[s : s + int(rng.integers(100, 200))]
            if i % 2:
                read = 3 - read[::-1]
            if i % 3 == 0:
                read = rng.integers(0, 5, int(rng.integers(20, 300)))
            f.write(f">r{i}\n" + "".join("ACGTN"[c] for c in read) + "\n")


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(28, 10), (32, 9), (97, 13)])
@pytest.mark.parametrize("prededup", [None, False])
def test_count_batches_cuda_matches_cpu(cuda, tmp_path, k, m, prededup):
    fa = str(tmp_path / "reads.fa")
    _write_fasta(fa, k)

    def run(device):
        return pipeline.count_batches(
            batching.batch_file(fa, 0, k, 8, 1024), k, m, 64, device=device,
            device_accumulate=True, prededup=prededup,
        )

    before = cuda_extract.LAUNCHES
    got = run(cuda)
    assert cuda_extract.LAUNCHES > before
    want = run("cpu")
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got.n_instances == want.n_instances > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(28, 10), (13, 4), (31, 8), (32, 9), (55, 9), (97, 13),
                                 (155, 14), (256, 15)])
def test_full_kernel_matches_plain(cuda, k, m):
    B = 2000
    for R, L in ((64, 1024), (3, k + 5), (1, k)):
        codes = torch.from_numpy(_codes(k + R + 1, R, L, k)).to(cuda)
        before = cuda_extract.FULL_LAUNCHES
        got = cuda_extract.extract_full(codes, k, m, B)
        torch.cuda.synchronize()
        assert cuda_extract.FULL_LAUNCHES == before + 1
        ref = extract.extract(codes, k, m, B)
        n = R * (L - k + 1)
        assert got.words.shape == (n, -(-k // 16)) and got.valid.dtype == torch.bool
        assert torch.equal(got.valid, ref.valid)
        v = ref.valid
        for a, b in ((got.words, ref.words), (got.sigs, ref.sigs), (got.bins, ref.bins)):
            assert a.is_cuda and a.dtype == torch.int32
            assert torch.equal(a[v], b[v])
        assert bool(((got.bins >= 0) & (got.bins < B)).all())  # in range everywhere


@pytest.mark.cuda
@pytest.mark.parametrize("smer", [True, False])
def test_mesh_job_cuda_matches_cpu(cuda, tmp_path, smer):
    fa = str(tmp_path / "reads.fa")
    _write_fasta(fa, 28)
    cfg = JobConfig(dataset=fa, output_directory="", k=28, m=10, max_b=64,
                    reads_per_batch=8, read_len=1024, write=False,
                    use_custom_partitioner=True, num_partition_tasks=4)

    def run(device):
        return driver.execute_job_distributed(
            cfg, exchange.make_mesh(2, device), smer_transport=smer, streaming=False,
            verbose=False,
        )

    before = cuda_extract.FULL_LAUNCHES
    got = run(cuda)
    assert cuda_extract.FULL_LAUNCHES > before
    want = run("cpu")
    for f in ("words", "counts", "bins", "owner_map"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.exchange_bytes == want.exchange_bytes and got.n_instances > 0


def _sort_lanes(seed: int, N: int, keys: int, vals: int) -> list:
    """int32 lanes: keys with sentinels (all-ones) and many ties, values."""
    rng = np.random.default_rng(seed)
    lanes = []
    for i in range(keys + vals):
        c = rng.integers(-(1 << 31), 1 << 31, size=N, dtype=np.int64)
        if i < keys:
            c[rng.random(N) < 0.2] = -1
            tie = rng.random(N) < 0.3
            c[tie] = rng.integers(-2, 3, size=int(tie.sum()))
        lanes.append(torch.from_numpy(c.astype(np.int32)))
    return lanes


@pytest.mark.cuda
@pytest.mark.parametrize("keys,vals", [(1, 0), (2, 1), (3, 1), (4, 0), (13, 1)])
@pytest.mark.parametrize("block", [1024, 8192, 1 << 15])
def test_block_sort_kernel_matches_plain(cuda, keys, vals, block):
    lanes = _sort_lanes(keys * block + vals, 4 * block, keys, vals)
    before = cuda_sort.LAUNCHES
    got = cuda_sort.sort_blocks(tuple(c.to(cuda) for c in lanes), keys, block)
    torch.cuda.synchronize()
    assert cuda_sort.LAUNCHES == before + 1
    ref = cuda_sort.sort_blocks_reference(tuple(lanes), keys, block)
    for g, r in zip(got[:keys], ref[:keys]):
        assert torch.equal(g.cpu(), r)
    rows_g = torch.stack([g.cpu() for g in got], 1).view(-1, block, keys + vals)
    rows_r = torch.stack(ref, 1).view(-1, block, keys + vals)
    for b in range(rows_g.shape[0]):  # per-block row multisets
        a = np.unique(rows_g[b].numpy(), axis=0, return_counts=True)
        c = np.unique(rows_r[b].numpy(), axis=0, return_counts=True)
        np.testing.assert_array_equal(a[0], c[0])
        np.testing.assert_array_equal(a[1], c[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(28, 10), (32, 9)])
@pytest.mark.parametrize("block_sort", [False, True])
def test_streaming_mesh_cuda_matches_cpu(cuda, tmp_path, monkeypatch, k, m, block_sort):
    fa = str(tmp_path / "reads.fa")
    _write_fasta(fa, k)
    cfg = JobConfig(dataset=fa, output_directory="", k=k, m=m, max_b=64,
                    reads_per_batch=8, read_len=1024, write=False,
                    use_custom_partitioner=True, num_partition_tasks=4)
    if block_sort:
        monkeypatch.setenv("FASTKMER_PALLAS_COMPACT", "1")

    def run(device):
        return driver.execute_job_distributed(cfg, exchange.make_mesh(2, device),
                                              verbose=False, acc_cap=4096, fanin=2)

    before = (cuda_extract.FULL_LAUNCHES, cuda_sort.LAUNCHES)
    got = run(cuda)
    assert cuda_extract.FULL_LAUNCHES > before[0]
    assert (cuda_sort.LAUNCHES > before[1]) == block_sort
    want = run("cpu")
    for f in ("words", "counts", "bins", "owner_map"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.exchange_bytes == want.exchange_bytes and got.n_instances > 0
    assert got.n_dedup_batches == want.n_dedup_batches
