"""The port's probe scripts (fastkmer_tpu_torch.benchmarks) on the CPU.

* Kernel D's plain version (``cuda_bitonic_merge.bitonic_merge`` on CPU
  tensors) against the JAX ``benchmarks.pallas_bitonic_merge.bitonic_merge``
  in interpret mode, on the inputs tests/test_pallas_sort.py builds (20%
  all-ones sentinels, 20% small ties): key lanes bit-equal, rows equal as a
  multiset.  Exact: both compute the same integer network.
* Kernel E's plain versions (``cuda_probe.copy_pass`` / ``transpose_pass``
  on CPU tensors) against the two Pallas bodies of benchmarks/pallas_probe.py,
  built here as ``pl.pallas_call(..., interpret=True)`` at [256, 128] with
  0xFFFFFFFF entries (which wrap to 0).  Exact.
* The ValueErrors where the JAX versions assert or their grids cannot run.
* The probes end to end at small sizes on ``device="cpu"``, the
  bench-layer five (``e2e``, ``mesh_dedup_probe``, ``merge_probe``,
  ``stream_probe``, ``skew``) included; the skew corpus is the JAX
  probe's draw for draw.
* The CPU twins of the two kernels' designs: D's merge path
  (``cuda_bitonic_merge.merge_path_twin``: partition, per-thread co-ranks,
  the A-first tie rule, at 64- and 256-row tiles) against the JAX merge
  and on the cases that break merge paths; E's swizzled shared layout
  (a bijection on the tile, every warp access at the least bank phases)
  and its load / T / S schedule (``cuda_probe.transpose_twin``) against the
  Pallas ``tr_kernel``.  Integer outputs: bit-equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy
from jax.experimental import pallas as pl  # noqa: E402

from benchmarks import pallas_bitonic_merge as pbm  # noqa: E402
from fastkmer_tpu_torch.benchmarks import (  # noqa: E402
    compact_probe, cuda_bitonic_merge, cuda_probe, e2e, merge_probe, mesh_dedup_probe,
    primitives, resume_merge_probe, roofline, skew, split_merge_probe, stream_probe,
)

MERGE_CASES = [(1, 0, 1024, 4096), (2, 1, 1024, 8192), (3, 2, 1024, 2048)]


def _mk_cols(rng, n_keys, n_vals, N):
    """tests/test_pallas_sort.py's lanes: keys with 20% sentinels and 20%
    small ties, then uniform value lanes (uint32)."""
    cols = []
    for _ in range(n_keys):
        c = rng.integers(0, 1 << 32, size=N, dtype=np.uint32)
        c[rng.random(N) < 0.2] = 0xFFFFFFFF
        m2 = rng.random(N) < 0.2
        c[m2] = rng.integers(0, 8, size=int(m2.sum()), dtype=np.uint32)
        cols.append(c)
    for _ in range(n_vals):
        cols.append(rng.integers(0, 1 << 32, size=N, dtype=np.uint32))
    return cols


def _merge_input(n_keys, n_vals, N):
    """[A ascending | B descending] rows (uint32 [N, lanes]), as
    test_pallas_sort.test_bitonic_merge_matches_full_sort arranges them."""
    rows = np.stack(_mk_cols(np.random.default_rng(11), n_keys, n_vals, N), 1)
    A, B = rows[: N // 2], rows[N // 2 :]
    A = A[np.lexsort([A[:, i] for i in reversed(range(n_keys))])]
    B = B[np.lexsort([B[:, i] for i in reversed(range(n_keys))])][::-1]
    return np.ascontiguousarray(np.concatenate([A, B], 0))


def _sorted_rows(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])]


@pytest.fixture(scope="module")
def jax_merges():
    """Each case's input and JAX result, made once per module."""
    out = {}
    for case in MERGE_CASES:
        n_keys, n_vals, block, N = case
        inp = _merge_input(n_keys, n_vals, N)
        res = pbm.bitonic_merge(tuple(jnp.asarray(np.ascontiguousarray(inp[:, i]))
                                      for i in range(inp.shape[1])),
                                num_keys=n_keys, block=block, interpret=True)
        out[case] = inp, np.stack([np.asarray(r) for r in res], 1)
    return out


@pytest.mark.parametrize("case", MERGE_CASES, ids=lambda c: "k{}v{}b{}N{}".format(*c))
def test_bitonic_merge_plain_matches_jax(jax_merges, case):
    n_keys, _, block, _ = case
    inp, want = jax_merges[case]
    cols = tuple(torch.from_numpy(inp[:, i].view(np.int32).copy()) for i in range(inp.shape[1]))
    before = cuda_bitonic_merge.LAUNCHES
    got = cuda_bitonic_merge.bitonic_merge(cols, n_keys, block)
    assert cuda_bitonic_merge.LAUNCHES == before  # the CPU takes the plain version
    got = np.stack([g.numpy().view(np.uint32) for g in got], 1)
    np.testing.assert_array_equal(got[:, :n_keys], want[:, :n_keys])
    np.testing.assert_array_equal(_sorted_rows(got), _sorted_rows(want))
    np.testing.assert_array_equal(_sorted_rows(got), _sorted_rows(inp))
    # the in-place form and the plain version itself give the same lanes
    buf = torch.stack(cols)
    cuda_bitonic_merge.bitonic_merge_(buf, n_keys, block)
    ref = cuda_bitonic_merge.bitonic_merge_reference(cols, n_keys, block)
    for i in range(len(cols)):
        np.testing.assert_array_equal(buf[i].numpy().view(np.uint32), got[:, i])
        np.testing.assert_array_equal(ref[i].numpy().view(np.uint32), got[:, i])


def test_bitonic_input_arranges_halves_for_the_merge():
    """``bitonic_input`` sorts the first half ascending and the second
    descending (its sentinels leading), from any rows."""
    rows = np.stack(_mk_cols(np.random.default_rng(5), 2, 1, 4096), 1)
    cols = tuple(torch.from_numpy(rows[:, i].view(np.int32).copy()) for i in range(3))
    buf = cuda_bitonic_merge.bitonic_input(cols, 2).numpy().view(np.uint32).T
    A, B = buf[:2048], buf[2048:]
    np.testing.assert_array_equal(A[:, :2], _sorted_rows(A[:, :2]))
    np.testing.assert_array_equal(B[::-1, :2], _sorted_rows(B[:, :2]))
    assert (B[0, :2] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(_sorted_rows(buf), _sorted_rows(rows))
    merged = cuda_bitonic_merge.bitonic_merge_(torch.from_numpy(buf.T.view(np.int32).copy()), 2,
                                               1024)
    np.testing.assert_array_equal(merged[0].numpy().view(np.uint32),
                                  _sorted_rows(rows[:, :2])[:, 0])


def _pallas_pass(body, a, b, grid, block_shape):
    spec = pl.BlockSpec(block_shape, lambda i: (i, 0))
    call = pl.pallas_call(body, grid=(grid,), in_specs=[spec, spec], out_specs=[spec, spec],
                          out_shape=[jax.ShapeDtypeStruct(a.shape, jnp.uint32)] * 2,
                          interpret=True)
    return [np.asarray(o) for o in call(jnp.asarray(a), jnp.asarray(b))]


def _copy_kernel(a_ref, b_ref, oa_ref, ob_ref):  # benchmarks/pallas_probe.py:32-34
    oa_ref[...] = a_ref[...] + jnp.uint32(1)
    ob_ref[...] = b_ref[...] + jnp.uint32(1)


def _tr_kernel(a_ref, b_ref, oa_ref, ob_ref):  # benchmarks/pallas_probe.py:36-42
    a = a_ref[...].T
    b = b_ref[...].T
    oa_ref[...] = (a + jnp.uint32(1)).T
    ob_ref[...] = (b + jnp.uint32(1)).T


@pytest.mark.parametrize("name", ["copy_pass", "transpose_pass"])
def test_pass_probe_plain_matches_pallas(name):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, size=(256, 128), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=(256, 128), dtype=np.uint32)
    a[0, :5] = b[255, 127] = b[7, 0] = 0xFFFFFFFF
    if name == "copy_pass":  # 2^14 values a grid step, as the probe's CH
        want = _pallas_pass(_copy_kernel, a, b, 2, (128, 128))
    else:
        want = _pallas_pass(_tr_kernel, a, b, 2, (128, 128))
    assert want[0][0, 0] == 0 and want[1][255, 127] == 0  # the wrap
    got = getattr(cuda_probe, name)(torch.from_numpy(a.view(np.int32)),
                                    torch.from_numpy(b.view(np.int32)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (256, 128)
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


@pytest.mark.parametrize("N,keys,block", [
    (3000, 1, 1024),      # N not a power of two
    (1024, 1, 1024),      # N < 2 block
    (4096, 1, 512),       # block below 1024
    (8192, 1, 3072),      # block not a power of two
    (4096, 0, 1024),      # no key
    (4096, 3, 1024),      # more keys than lanes
])
def test_bitonic_merge_refuses_what_jax_asserts(N, keys, block):
    cols = (torch.zeros(N, dtype=torch.int32), torch.zeros(N, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_bitonic_merge.bitonic_merge(cols, keys, block)
    with pytest.raises(ValueError):
        cuda_bitonic_merge.bitonic_merge_reference(cols, keys, block)
    legal = (torch.zeros(2048, dtype=torch.int64), torch.zeros(2048, dtype=torch.int32))
    with pytest.raises(TypeError):  # the lanes' type is checked too
        cuda_bitonic_merge.bitonic_merge(legal, 1, 1024)


@pytest.mark.parametrize("shape", [(64, 128), (200, 128), (128, 64), (128 * 128,)])
def test_pass_probes_refuse_shapes_no_grid_runs(shape):
    a = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        cuda_probe.copy_pass(a, a)
    with pytest.raises((ValueError, TypeError)):
        cuda_probe.transpose_pass(a, a)


def test_split_merge_probe_on_cpu():
    lines = split_merge_probe.run(12, "cpu")
    assert [x["measure"] for x in lines] == [
        "hw_split_merge_exactness_2^12", "torch_sort_2^12", "split_sort_merge_2^12",
        "bitonic_merge_only_2^12"]
    assert lines[0]["keys_ok"] and lines[0]["rows_multiset_ok"]
    assert all(x["device"] == "cpu" for x in lines) and lines[-1]["kernel_ms"] is None


def test_resume_merge_probe_arms_on_cpu():
    n = 1 << 12
    pa, pb = resume_merge_probe.sorted_part(1, n), resume_merge_probe.sorted_part(2, n)
    # the host merge's table against a numpy oracle: equal words' counts summed
    words, counts, _ = resume_merge_probe.host_merge(pa, pb)
    allw = np.concatenate([pa[0], pb[0]])
    uw, inv = np.unique(allw, axis=0, return_inverse=True)
    np.testing.assert_array_equal(words, uw)
    np.testing.assert_array_equal(counts, np.bincount(inv.ravel(), minlength=uw.shape[0]))
    # the device arm's keys are the sorted union of the padded lanes
    host = np.concatenate([resume_merge_probe.pad_cols(pa, False, n),
                           resume_merge_probe.pad_cols(pb, True, n)], axis=1)
    merged = resume_merge_probe.device_merge(host, torch.device("cpu"), 1024)
    rows = host.view(np.uint32).T
    want = _sorted_rows(rows)
    np.testing.assert_array_equal(merged.view(np.uint32)[:2].T, want[:, :2])
    np.testing.assert_array_equal(_sorted_rows(merged.view(np.uint32).T), want)
    line = resume_merge_probe.run(n, "cpu")
    assert line["rows"] == pa[0].shape[0] + pb[0].shape[0]
    assert line["device"] == "cpu" and line["kernel_ms"] is None
    assert line["host_s"] > 0 and line["device_roundtrip_s"] > 0


def test_cuda_probe_on_cpu():
    lines = cuda_probe.run(14, "cpu")
    assert [x["probe"] for x in lines] == ["copy_pass", "transpose_pass"]
    assert all(x["N"] == 1 << 14 and x["kernel_ms"] is None for x in lines)


def test_yardstick_probes_on_cpu():
    """roofline, compact_probe and primitives at small sizes: every line,
    and the two compaction routes exact."""
    lines = roofline.run("all", "cpu", sizes=(12, 13, 14), sort_sizes=(12, 13),
                         merge_rows=1 << 14)
    assert [x["measure"] for x in lines] == (
        ["per_call_overhead"] + [f"elementwise_2col_2^{lg}" for lg in (12, 13, 14)]
        + [f"{s}_2^{lg}" for lg in (12, 13) for s in ("sort_1op", "sort_2op", "sort_2key_1val")]
        + ["merge_full_151M", "merge_sort_only_151M"])
    lines = compact_probe.run("blocks", "cpu", rows=1 << 16, exact_rows=1 << 14)
    assert lines[0] == {"measure": "hw_merge_exactness_2^14", "device": "cpu", "ok": True,
                        "n_u": lines[0]["n_u"]} and lines[0]["n_u"] > 0
    assert [x["measure"] for x in lines[1:]] == [
        "merge_full_151M_block_sort_b32768", "merge_full_151M_block_sort_b65536",
        "merge_full_151M_default_b32768"]
    lines = primitives.run(10, "cpu")
    assert [x["primitive"] for x in lines] == [
        f"{p}_2^10" for p in ("sort_1op", "sort_2op", "sort_2key_1val", "gather",
                              "searchsorted", "cumsum", "searchsorted_gather")]


@pytest.fixture
def one_thread():
    """One torch thread: these probes run many small ops, which several
    test workers' thread pools would otherwise fight over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_layer_probes_on_cpu(one_thread):
    """e2e, mesh_dedup_probe, merge_probe, stream_probe and skew at small
    sizes: every field, the arms' and merges' equality checks inside."""
    line = e2e.run(4, 2, 16, R=64, L=256, device="cpu")
    assert line["metric"] == "e2e_stream_throughput_k28_m10" and line["value"] > 0
    assert line["acc_cap"] == 1 << 16 and line["n_unique"] > 0 and line["device"] == "cpu"
    line = mesh_dedup_probe.run(4, 64, 256, 1 << 12, 4, 2, device="cpu")
    arms = line["arms"]
    assert [a["n_dedup_batches"] for a in arms.values()] == [0, 1, 4]
    assert len({a["uniques"] for a in arms.values()}) == 1
    assert line["bytes_ratio_dedup_vs_raw"] == (arms["dedup"]["exchange_bytes"]
                                                / arms["raw"]["exchange_bytes"])
    line = merge_probe.run(1 << 15, 3000, 4000, iters=1, device="cpu")
    assert line["merge_rows"] == 8 * 3000 + 4000 and line["device"] == "cpu"
    assert all(line[f] > 0 for f in ("sort2_ms", "sort3_ms", "count_presentineled_ms",
                                     "merge_ms", "merge_block_sort_ms"))
    line = stream_probe.run(64, 256, 1 << 13, 4, device="cpu")
    assert [len(r["dispatch_s"]) for r in line["reps"]] == [4, 4]
    assert line["reps"][0]["n_unique"] == line["reps"][1]["n_unique"] > 0
    line = skew.run(0.7, 32, 4, device="cpu")
    assert line["lpt"]["imbalance"] <= line["hash"]["imbalance"]
    assert line["placement"] == ["cpu"] * 4 and abs(sum(line["bins_hot_top8"])) <= 1


def test_skew_corpus_is_the_jax_one():
    from benchmarks import skew as jskew

    for frac in (0.0, 0.7):
        want = jskew.make_skewed_reads(np.random.default_rng(0), 32, 512, frac)
        got = skew.make_skewed_reads(np.random.default_rng(0), 32, 512, frac)
        np.testing.assert_array_equal(got, want)


def test_probes_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        split_merge_probe.run(12, "cuda")
    with pytest.raises(RuntimeError):
        cuda_probe.run(14)
    for probe in (e2e.run, mesh_dedup_probe.run, merge_probe.run, stream_probe.run, skew.run):
        with pytest.raises(RuntimeError, match="is_available"):
            probe()


# --- the designs of kernels D (merge path) and E (swizzled transpose), on the CPU


@pytest.mark.parametrize("case", MERGE_CASES, ids=lambda c: "k{}v{}b{}N{}".format(*c))
def test_merge_path_twin_matches_jax(jax_merges, case):
    """The kernel's partition, per-thread co-ranks and tie rule at a 64-row
    tile against the JAX merge: keys bit-equal, rows the same multiset."""
    n_keys = case[0]
    inp, want = jax_merges[case]
    cols = tuple(torch.from_numpy(inp[:, i].view(np.int32).copy()) for i in range(inp.shape[1]))
    got = cuda_bitonic_merge.merge_path_twin(cols, n_keys, tile=64)
    got = np.stack([g.numpy().view(np.uint32) for g in got], 1)
    np.testing.assert_array_equal(got[:, :n_keys], want[:, :n_keys])
    np.testing.assert_array_equal(_sorted_rows(got), _sorted_rows(want))


def _edge_rows(case: str) -> tuple:
    """[A ascending | B descending] rows (uint32 [N, lanes]) and the key
    count of one case that breaks merge paths."""
    rng = np.random.default_rng(len(case))
    n_keys, n_vals, N = {"15+1": (15, 1, 2048), "smallest": (2, 1, 2048)}.get(case, (2, 1, 4096))
    if case in ("15+1", "smallest"):
        return _merge_input(n_keys, n_vals, N), n_keys
    rows = rng.integers(0, 1 << 32, size=(N, n_keys + n_vals), dtype=np.uint64).astype(np.uint32)
    h = N // 2
    if case == "a_below_b":  # every tile wholly from A, then wholly from B
        rows[:h, 0] = rng.integers(0, 1 << 20, size=h)
        rows[h:, 0] = rng.integers(1 << 21, 1 << 22, size=h)
    elif case == "b_below_a":
        rows[:h, 0] = rng.integers(1 << 21, 1 << 22, size=h)
        rows[h:, 0] = rng.integers(0, 1 << 20, size=h)
    elif case == "runs":  # A and B alternate in runs longer than a tile
        rows[:, 0] = rng.integers(0, 8, size=N) * (1 << 24) + np.arange(N) % 2
    elif case == "equal":
        rows[:, :n_keys] = 5
    elif case == "sentinel":  # 90% of each half sentinel rows of count 0
        dead = rng.random(N) < 0.9
        rows[dead, :n_keys] = 0xFFFFFFFF
        rows[dead, -1] = 0
    A, B = rows[:h], rows[h:]
    A = A[np.lexsort([A[:, i] for i in reversed(range(n_keys))])]
    B = B[np.lexsort([B[:, i] for i in reversed(range(n_keys))])][::-1]
    return np.ascontiguousarray(np.concatenate([A, B], 0)), n_keys


@pytest.mark.parametrize("case", ["a_below_b", "b_below_a", "runs", "equal", "sentinel",
                                  "smallest", "15+1"])
@pytest.mark.parametrize("tile", [64, 256])
def test_merge_path_twin_edge_cases(case, tile):
    """Tiles wholly from A or wholly from B, runs of one half longer than a
    tile, all-equal keys, halves 90% sentinel, the smallest legal N = 2 ×
    1024, 15 keys + 1 value: keys equal to the sorted keys, rows the same
    multiset, and the plain network agrees."""
    rows, n_keys = _edge_rows(case)
    cols = tuple(torch.from_numpy(rows[:, i].view(np.int32).copy()) for i in range(rows.shape[1]))
    got = cuda_bitonic_merge.merge_path_twin(cols, n_keys, tile=tile)
    got = np.stack([g.numpy().view(np.uint32) for g in got], 1)
    want = _sorted_rows(rows)
    np.testing.assert_array_equal(got[:, :n_keys], want[:, :n_keys])
    np.testing.assert_array_equal(_sorted_rows(got), want)
    ref = cuda_bitonic_merge.bitonic_merge_reference(cols, n_keys, 1024)
    np.testing.assert_array_equal(np.stack([r.numpy().view(np.uint32) for r in ref], 1)[:, :n_keys],
                                  got[:, :n_keys])


@pytest.mark.parametrize("lanes,N,tile", [(1, 1 << 27, 4096), (2, 1 << 27, 2048),
                                          (3, 1 << 27, 2048), (4, 1 << 27, 1024),
                                          (16, 1 << 16, 256), (3, 2048, 2048),
                                          (100, 1 << 20, 512)])
def test_merge_tile_fits_shared_memory(lanes, N, tile):
    """Six merge CTAs an SM where a 256-row tile fits in 32 KB, else one
    in 227 KB; never more rows than N."""
    assert cuda_bitonic_merge.merge_tile(lanes, N) == tile
    assert (lanes + 1) * 4 * tile <= cuda_bitonic_merge.SMEM_BYTES
    if lanes < 32:
        assert (lanes + 1) * 4 * tile <= cuda_bitonic_merge.TILE_BYTES
    with pytest.raises(ValueError):
        cuda_bitonic_merge.merge_tile(300, N)


def test_merge_into_needs_the_card():
    """The out-of-place kernel entry has no plain route: a CPU tensor
    raises (``bitonic_merge`` and ``bitonic_merge_`` take the plain network
    there)."""
    src = torch.zeros((3, 2048), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_bitonic_merge.merge_into(src, torch.empty_like(src),
                                      torch.empty(2, dtype=torch.int64), 2)


def test_transpose_swizzle_is_a_bijection():
    r, q = np.meshgrid(np.arange(cuda_probe.TILE), np.arange(cuda_probe.TILE_CHUNKS),
                       indexing="ij")
    s = cuda_probe.swizzle(r, q)
    assert sorted(s.ravel().tolist()) == list(range(cuda_probe.TILE * cuda_probe.TILE_CHUNKS))
    # a row keeps its own 32 chunks: the swizzle permutes within the row
    np.testing.assert_array_equal(s // cuda_probe.TILE_CHUNKS, r)


@pytest.mark.parametrize("access", ["load", "T_read", "T_write", "S_read"])
def test_transpose_accesses_hit_distinct_banks(access):
    """Every 16-byte warp access of the transpose takes the least 4 shared
    phases (each quarter warp on 8 different bank groups); without the
    swizzle the accesses down a column of blocks would take 32."""
    rows, chunks = cuda_probe.transpose_accesses()[access]
    assert rows.shape == chunks.shape == (128, 32)
    assert (cuda_probe.bank_phases(rows, chunks) == 4).all()
    plain = cuda_probe.bank_phases(rows, chunks, layout=lambda r, q: r * 32 + q)
    assert plain.max() == (32 if access in ("T_read", "S_read") else 4)


def test_transpose_accesses_cover_each_tile_chunk_once():
    """The load, T's reads and writes, and S's reads each touch every
    16-byte chunk of a tile exactly once."""
    for rows, chunks in cuda_probe.transpose_accesses().values():
        idx = cuda_probe.swizzle(rows, chunks).ravel()
        assert sorted(idx.tolist()) == list(range(cuda_probe.TILE * cuda_probe.TILE_CHUNKS))


def test_transpose_twin_matches_pallas():
    """The kernel's schedule on each tile against the Pallas tr_kernel in
    interpret mode: bit-equal, 0xFFFFFFFF wrapping to 0."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 1 << 32, size=(256, 128), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=(256, 128), dtype=np.uint32)
    a[3, :7] = b[200, 100] = 0xFFFFFFFF
    want = _pallas_pass(_tr_kernel, a, b, 2, (128, 128))
    for x, w in zip((a, b), want):
        got = np.concatenate([cuda_probe.transpose_twin(x[t * 128:(t + 1) * 128])
                              for t in range(2)])
        np.testing.assert_array_equal(got, w)


def test_pass_wrappers_on_cpu_take_the_plain_version():
    """A CPU tensor takes ``pass_reference`` and moves no launch count."""
    a = torch.arange(1 << 14, dtype=torch.int32).view(-1, 128)
    before = cuda_probe.COPY_LAUNCHES, cuda_probe.TRANSPOSE_LAUNCHES
    for fn in (cuda_probe.copy_pass, cuda_probe.transpose_pass):
        for g in fn(a, a):
            assert torch.equal(g, a + 1)
    assert (cuda_probe.COPY_LAUNCHES, cuda_probe.TRANSPOSE_LAUNCHES) == before
