"""Card tests of fastkmer_tpu_torch, marked ``cuda``; each skips without a
CUDA device.  The CUDA extract kernels (count and full mode) and the block
sort kernel are held against their plain torch versions (bit-equality,
where valid for full mode's words and sigs; keys bit-equal and row
multisets equal per block for the sort), and the count job and 2-shard
mesh jobs (per batch and streaming, with and without the block-sort
compaction; the HT engine on one device through kernel A and on the mesh
through kernel B; multiseq on one device through kernel A and on a
2-shard streaming mesh through kernel B, and the device Gram of its
distances with TF32 allowed) on cuda against the same jobs
on the CPU; edge shapes of
the redesigned kernels (k = m + 1, k = 4, k = 256, rows of k bases, a row
ending on a block of starts, the count kernel's flag lane, its opt-in
shared memory and its byte route at the wrapper's largest k; all-equal
and mostly-sentinel sort blocks, 13 keys, and the tiled route); the
probes' kernels D (the merge path, in place and out of place: keys
bit-equal to the plain version and to the sorted keys, rows the same
multiset, also where tiles come wholly from one half) and E (the
copy and the transpose: bit-equal, 0xFFFFFFFF wrapping to 0, a tile
count uneven among the persistent CTAs); and the exchange between two
ranks that share the card, with and without pinned host staging.  No jax is needed, so a machine with a
card and no jax runs them without the jax-importing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fastkmer_tpu_torch import pipeline  # noqa: E402
from fastkmer_tpu_torch.config import JobConfig  # noqa: E402
from fastkmer_tpu_torch.benchmarks import cuda_bitonic_merge, cuda_probe  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as batching  # noqa: E402
from fastkmer_tpu_torch.ops import count_sort, cuda_extract, cuda_sort, extract  # noqa: E402
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
@pytest.mark.parametrize("k,R,L,route", [
    (28, 5, 2048 + 27, "staged"),      # P = 2048: one full block of starts a row
    (28, 5, 4096 + 28, "staged"),      # P = 4097: one start past two blocks
    (97, 5, 3 * 1024 + 96, "staged"),  # three full blocks of 1024, a long halo
    (55, 5, 1024 + 54, "staged"),      # P = 1024
    (4, 64, 1024, "staged"),
    (256, 8, 256, "staged"),           # rows of exactly k, with the flag lane
    (32, 5, 2048 + 32, "staged"),      # the flag lane
    (64, 5, 1024 + 63, "staged"),
    (3001, 5, 3001 + 2100, "staged"),  # over 48 KB of shared memory: opts in
    (cuda_extract._MAX_K_STAGED, 3, cuda_extract._MAX_K_STAGED + 1500, "staged"),
    (cuda_extract._MAX_K, 3, cuda_extract._MAX_K + 300, "bytes"),  # the wrapper's largest k
])
def test_count_kernel_edge_shapes(cuda, k, R, L, route):
    assert cuda_extract.count_route(k) == route
    codes = _codes(k * 7 + R, R, L, k)
    if k > 256:  # windows that long hold an N almost always: one N in row 2 only
        codes[1:][codes[1:] == 4] = 1
        codes[2, L // 2] = 4
    codes[3:4, 1023:1025] = 4  # Ns on a 1024-start block boundary
    codes[4:5, 2047:2049] = 4  # and on a 2048-start one
    codes = torch.from_numpy(codes).to(cuda)
    flag = k % 16 == 0
    before = cuda_extract.LAUNCHES
    got = cuda_extract.extract_sentinel(codes, k, 4, 64, flag_lane=flag)
    torch.cuda.synchronize()
    assert cuda_extract.LAUNCHES == before + 1
    ref = cuda_extract.extract_sentinel_reference(codes, k, 4, 64, flag_lane=flag)
    assert len(got) == len(ref) == -(-k // 16) + int(flag)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


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
@pytest.mark.parametrize("k,m,R,L", [
    (11, 10, 64, 1024),          # k = m + 1: windows of one norm
    (256, 15, 8, 256),           # the largest k, rows of exactly k
    (28, 10, 5, 1024 + 27),      # P = 1024: one full block of starts a row
    (28, 10, 5, 2048 + 28),      # P = 2049: one start past two blocks
    (97, 13, 3, 3 * 1024 + 96),  # three full blocks, a long halo
])
def test_full_kernel_edge_shapes(cuda, k, m, R, L):
    codes = _codes(k * 7 + R, R, L, k)
    codes[3:4, 1023:1025] = 4  # Ns on the kernel's block boundary
    codes = torch.from_numpy(codes).to(cuda)
    got = cuda_extract.extract_full(codes, k, m, 2000)
    torch.cuda.synchronize()
    ref = extract.extract(codes, k, m, 2000)
    assert got.valid.dtype == torch.bool and torch.equal(got.valid, ref.valid)
    v = ref.valid
    for a, b in ((got.words, ref.words), (got.sigs, ref.sigs), (got.bins, ref.bins)):
        assert torch.equal(a[v], b[v])
    assert bool(((got.bins >= 0) & (got.bins < 2000)).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(28, 10), (32, 9), (55, 9)])
def test_ht_count_cuda_matches_cpu(cuda, tmp_path, k, m):
    """The HT engine's single-device step extracts through kernel A (one
    launch a batch; the flag lane at k = 32) and gives the CPU run's table;
    it equals the sort engine's."""
    fa = str(tmp_path / "reads.fa")
    _write_fasta(fa, k)

    def run(device, engine="hash"):
        return pipeline.count_batches(batching.batch_file(fa, 0, k, 8, 1024), k, m, 64,
                                      device=device, engine=engine)

    before = cuda_extract.LAUNCHES
    got = run(cuda)
    assert cuda_extract.LAUNCHES == before + got.n_batches > before
    for want in (run("cpu"), run(cuda, "sort")):
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
    assert got.n_instances > 0


@pytest.mark.cuda
@pytest.mark.parametrize("smer", [True, False])
def test_mesh_ht_cuda_matches_cpu(cuda, tmp_path, smer):
    """The mesh's HT step routes through kernel B (a launch per shard and
    batch, none of kernel A) and gives the CPU run's table."""
    fa = str(tmp_path / "reads.fa")
    _write_fasta(fa, 40)
    cfg = JobConfig(dataset=fa, output_directory="", k=40, m=9, max_b=64,
                    reads_per_batch=8, read_len=1024, write=False, use_ht=True)

    def run(device):
        return driver.execute_job_distributed(cfg, exchange.make_mesh(2, device),
                                              smer_transport=smer, verbose=False)

    before = (cuda_extract.FULL_LAUNCHES, cuda_extract.LAUNCHES)
    got = run(cuda)
    assert cuda_extract.FULL_LAUNCHES >= before[0] + 2 * got.n_batches
    assert cuda_extract.LAUNCHES == before[1]
    want = run("cpu")
    for f in ("words", "counts", "bins"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.n_instances > 0


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
@pytest.mark.parametrize("case", ["equal", "sentinel", "13+1", "tiled"])
def test_block_sort_kernel_edge_cases(cuda, case):
    """All-equal keys; blocks that are mostly sentinel rows of count 0 (the
    compaction's padding); 13 keys and a value (run-time lane counts); 15
    keys and a value (no cluster holds a block: the tiled route)."""
    block = 1 << 15
    keys, vals = {"equal": (2, 1), "sentinel": (2, 1), "13+1": (13, 1), "tiled": (15, 1)}[case]
    lanes = _sort_lanes(keys + 17, 4 * block, keys, vals)
    if case == "equal":
        for c in lanes[:keys]:
            c.fill_(5)
    elif case == "sentinel":
        dead = torch.rand(4 * block, generator=torch.Generator().manual_seed(3)) < 0.9
        for c in lanes[:keys]:
            c[dead] = -1
        lanes[-1][dead] = 0
    plan = cuda_sort.stage_plan(keys + vals, block)
    assert plan.route == ("tiled" if case == "tiled" else "cluster")
    got = cuda_sort.sort_blocks(tuple(c.to(cuda) for c in lanes), keys, block)
    torch.cuda.synchronize()
    ref = cuda_sort.sort_blocks_reference(tuple(lanes), keys, block)
    for g, r in zip(got[:keys], ref[:keys]):
        assert torch.equal(g.cpu(), r)
    whole = keys + vals
    for g, r in zip(cuda_sort.sort_blocks_reference(tuple(c.cpu() for c in got), whole, block),
                    cuda_sort.sort_blocks_reference(ref, whole, block)):
        assert torch.equal(g, r)  # each block's rows, as a multiset


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [128, 256, 128 * 131, 1 << 17])
def test_pass_probe_kernels_match_plain(cuda, rows):
    """The copy and the transpose; 128 · 131 rows are 131 tiles a
    lane, 262 in all, which do not divide evenly among the persistent
    transpose CTAs."""
    rng = np.random.default_rng(rows)
    a, b = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(rows, 128),
                                          dtype=np.int64).astype(np.int32)) for _ in range(2))
    a[0, :3] = -1  # 0xFFFFFFFF: wraps to 0
    b[-1, -1] = -1
    a, b = a.to(cuda), b.to(cuda)
    for fn, counter in ((cuda_probe.copy_pass, "COPY_LAUNCHES"),
                        (cuda_probe.transpose_pass, "TRANSPOSE_LAUNCHES")):
        before = getattr(cuda_probe, counter)
        got = fn(a, b)
        torch.cuda.synchronize()
        assert getattr(cuda_probe, counter) == before + 1
        for g, x in zip(got, (a, b)):
            assert g.is_cuda and g.dtype == torch.int32 and g.shape == x.shape
            assert torch.equal(g, cuda_probe.pass_reference(x))
        assert int(got[0][0, 0]) == 0 and int(got[1][-1, -1]) == 0


def _merge_matches_plain(cuda, lanes: list, keys: int) -> None:
    """Kernel D on [A ascending | B descending] rows of ``lanes`` against its
    plain version: keys bit-equal (and equal to the sorted keys), rows the
    same multiset."""
    src = cuda_bitonic_merge.bitonic_input(tuple(lanes), keys)
    before = cuda_bitonic_merge.LAUNCHES
    got = cuda_bitonic_merge.bitonic_merge_(src.to(cuda), keys, 1024)
    torch.cuda.synchronize()
    assert cuda_bitonic_merge.LAUNCHES == before + 1
    got = [g.cpu() for g in got]
    # the out-of-place form: new lanes, the input untouched, the same rows
    dsrc = src.to(cuda)
    new = cuda_bitonic_merge.bitonic_merge(tuple(dsrc), keys, 1024)
    torch.cuda.synchronize()
    assert cuda_bitonic_merge.LAUNCHES == before + 2
    assert torch.equal(dsrc.cpu(), src)
    for g, n in zip(got, new):
        assert torch.equal(g, n.cpu())
    ref = cuda_bitonic_merge.bitonic_merge_reference(tuple(src), keys, 1024)
    want = count_sort.sort_columns(list(lanes[:keys]))[0]
    for g, r, w in zip(got[:keys], ref[:keys], want):
        assert torch.equal(g, r) and torch.equal(g, w)
    for g, r in zip(count_sort.sort_columns(got)[0], count_sort.sort_columns(list(ref))[0]):
        assert torch.equal(g, r)  # the rows, as a multiset


@pytest.mark.cuda
@pytest.mark.parametrize("keys,vals", [(1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)])
@pytest.mark.parametrize("N", [1 << 11, 1 << 17])
def test_bitonic_merge_kernel_matches_plain(cuda, keys, vals, N):
    """N = 2^11 is one shared-memory tile; 2^17 is several, with cross
    stages in device memory."""
    _merge_matches_plain(cuda, _sort_lanes(N + keys * 2 + vals, N, keys, vals), keys)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["equal", "sentinel", "15+1"])
def test_bitonic_merge_kernel_edge_cases(cuda, case):
    """All-equal keys; halves that are mostly sentinel rows of count 0 (the
    resume probe's padding); 15 keys and a value (run-time lane counts, a
    2048-row tile)."""
    N = 1 << 16
    keys = 15 if case == "15+1" else 2
    lanes = _sort_lanes(keys + 29, N, keys, 1)
    if case == "equal":
        for c in lanes[:keys]:
            c.fill_(5)
    elif case == "sentinel":
        dead = torch.rand(N, generator=torch.Generator().manual_seed(4)) < 0.9
        for c in lanes[:keys]:
            c[dead] = -1
        lanes[-1][dead] = 0
    _merge_matches_plain(cuda, lanes, keys)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["a_below_b", "b_below_a", "runs", "smallest"])
def test_merge_path_kernel_tile_edges(cuda, case):
    """The merge path's hard cases at the kernel's own tiles (2048 rows at
    3 lanes, 32 of them at 2^16 rows): tiles wholly from A, then wholly from B (and the reverse),
    runs of one half longer than a tile, and the smallest legal N = 2048
    (one tile)."""
    N = 2048 if case == "smallest" else 1 << 16
    lanes = _sort_lanes(N + len(case), N, 2, 1)
    h = N // 2
    idx = torch.arange(N, dtype=torch.int32)
    if case == "a_below_b":
        lanes[0][:h] = idx[:h] % 1000
        lanes[0][h:] = 5000 + idx[h:] % 1000
    elif case == "b_below_a":
        lanes[0][:h] = 5000 + idx[:h] % 1000
        lanes[0][h:] = idx[h:] % 1000
    elif case == "runs":  # runs of 8192 equal leading keys, A and B alternating
        lanes[0][:] = ((idx % h) // 8192) * 2 + (idx >= h).to(torch.int32)
    _merge_matches_plain(cuda, lanes, 2)


def _write_multiseq_fasta(path: str, n_seq: int = 3) -> None:
    """Reads of one 600-base backbone with 1% substitutions and some Ns,
    headers ``S<s>.<i>``: the sequences share most k-mers."""
    rng = np.random.default_rng(9)
    backbone = rng.integers(0, 4, size=600)
    with open(path, "w") as f:
        for s in range(n_seq):
            for i in range(40):
                st = int(rng.integers(0, 450))
                r = backbone[st : st + 150].copy()
                sub = rng.random(r.size) < 0.01
                r[sub] = rng.integers(0, 4, size=int(sub.sum()))
                r[rng.random(r.size) < 0.005] = 4
                f.write(f">S{s}.{i}\n{''.join('ACGTN'[c] for c in r)}\n")


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(28, 10), (32, 9), (55, 9)])
@pytest.mark.parametrize("mesh", [1, 2])
def test_multiseq_cuda_matches_cpu(cuda, tmp_path, k, m, mesh):
    """Multiseq through kernel A on one device (the flag lane at k = 32
    replaced by the seq lane) or kernel B on a 2-shard streaming mesh: the
    CPU run's (k-mer, seq) table, names and distances."""
    from fastkmer_tpu_torch.multiseq import distributed, pipeline as ms

    fa = str(tmp_path / "ms.fa")
    _write_multiseq_fasta(fa)
    cfg = ms.MultiseqConfig(dataset=fa, output_directory="", k=k, m=m, max_b=64,
                            reads_per_batch=8, read_len=512, write=False,
                            distance_measure="kld_log2")

    def run(device):
        if mesh == 1:
            return ms.execute_multiseq_job(cfg, verbose=False, device=device,
                                           device_accumulate=True)
        return distributed.execute_multiseq_job_distributed(
            cfg, exchange.make_mesh(mesh, device), verbose=False)

    before = cuda_extract.LAUNCHES, cuda_extract.FULL_LAUNCHES
    got = run(cuda)
    a, b = cuda_extract.LAUNCHES - before[0], cuda_extract.FULL_LAUNCHES - before[1]
    assert (a, b > 0) == ((got.n_batches, False) if mesh == 1 else (0, True))
    want = run("cpu")
    for f in ("words", "seqs", "counts", "bins"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.sequence_names == want.sequence_names == ["S0", "S1", "S2"]
    assert got.distances == want.distances


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["multisequence.SquaredEuclidean", "multisequence.KLDLog2"])
def test_device_gram_ignores_tf32(cuda, name):
    """The device Gram on the card with TF32 allowed process-wide: its
    float64 matmuls give the CPU's result to 1e-9, and the setting is left
    as it was."""
    from fastkmer_tpu_torch.multiseq import distances, pipeline as ms

    measure = distances.get_measure(name)
    rng = np.random.default_rng(5)
    S, G = 8, 20000
    keep = rng.random((G, S)) < 0.6
    gid, seqs = np.nonzero(keep)
    counts = rng.integers(1, 3000, size=gid.size).astype(np.float64)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = ms._pair_sums_from_device(gid, seqs.astype(np.int32), counts, S, measure,
                                        device=cuda)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want = ms._pair_sums_from_device(gid, seqs.astype(np.int32), counts, S, measure,
                                     device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


_RANK_EXCHANGE = r'''
import os, sys
sys.path.insert(0, sys.argv[2])
import torch
from fastkmer_tpu_torch.parallel import exchange, multihost
multihost.init_distributed(device="cuda", timeout_s=60)
mesh = multihost.init_global_mesh(2, "cuda")
mesh.comm.staging = sys.argv[1]
n, cap, lanes = mesh.size, 5, 3


def send_of(g):
    """Global shard g's send lanes: int32 [n * cap] each, from its own seed."""
    gen = torch.Generator().manual_seed(g)
    return [torch.randint(-2**31, 2**31 - 1, (n * cap,), generator=gen, dtype=torch.int32)
            for _ in range(lanes)]


everyone = [send_of(g) for g in range(n)]
send = [[l.to(mesh.devices[0]) for l in everyone[mesh.offset + j]] for j in range(2)]
recv = exchange._exchange(mesh, cap, send)
for j in range(2):
    d = mesh.offset + j
    for i in range(lanes):
        want = torch.cat([everyone[s][i][d * cap : (d + 1) * cap] for s in range(n)])
        assert recv[j][i].device.type == "cuda" and torch.equal(recv[j][i].cpu(), want), (j, i)
got = mesh.comm.reduce(torch.tensor([mesh.rank + 1, 5 * mesh.rank], device="cuda"), "max")
assert got.device.type == "cuda" and got.tolist() == [2, 5]
assert multihost.agree_min(7 - mesh.rank, mesh.comm) == 6
print("RANK_OK", mesh.rank, flush=True)
'''


@pytest.mark.cuda
@pytest.mark.parametrize("staging", ["direct", "host"])
def test_exchange_across_ranks_on_cuda(cuda, tmp_path, staging):
    """Two ranks of two shards on the card (gloo: they share it): the
    exchange between ranks puts block d of global source s in destination
    d's lane at s, whether gloo takes the CUDA tensors (``direct``) or they
    go through pinned host buffers (``host``); the reductions and
    ``agree_min`` on CUDA tensors."""
    import os
    import socket
    import subprocess
    import sys

    script = tmp_path / "rank.py"
    script.write_text(_RANK_EXCHANGE)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), staging, repo],
        env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
             "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": port},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, out in enumerate(outs):
        assert f"RANK_OK {r}" in out, out[-3000:]
