"""The probes of kernels A, B and C (fastkmer_tpu_torch.benchmarks:
``bigk_probe``, ``smer_pallas_probe``, ``pallas_sort_probe``, ``scaling``)
on the CPU, held against their JAX counterparts in the root
``benchmarks/``.

* ``scaling``: the JAX probe's ``main()`` once per module, on the 8
  virtual CPU devices, with ``sys.argv`` set to 16 reads a shard of 1024
  bases; the port's ``run(16, 1024)`` gives the same ``reads``,
  ``exchange_bytes``, worst case and ``dropped`` at every mesh size (the
  sized cap is below the worst case at n = 4 and 8).
* ``bigk_probe``: at R, L = 8, 512 and k = 75 and 201, the plain and the
  kernel arm's counts equal the JAX probe's ``jnp_step`` (JAX extract,
  sentinel, ``count_presentineled``), built here.
* ``smer_pallas_probe``: at R, L = 16, 512 both arms drop nothing and give
  one table; the kernel arm is the public step; the plain arm's table
  equals the JAX step's without Pallas on the same reads.  The JAX probe
  reads ``sys.argv`` when imported, so it is never imported here.
* ``pallas_sort_probe``: exactness and every field at 2^14 rows, and a
  raise on a wrong sort; its ``stages`` (``cuda_sort.stage_plan``'s)
  equal the JAX probe's ``n_stages`` for blocks of 2^10-2^17.
* the command lines take the JAX probes' arguments and ``--device``
  alone: none for ``bigk_probe``, ``[lgN] [blocks...]`` for
  ``pallas_sort_probe``.

Integer tables and byte counts: the tolerance is equality.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from fastkmer_tpu_torch.benchmarks import (  # noqa: E402
    bigk_probe, pallas_sort_probe, scaling, smer_pallas_probe,
)
from fastkmer_tpu_torch.ops import cuda_sort  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange  # noqa: E402

SCALING_ARGS = (16, 1024)
SCALING_FIELDS = ("mesh", "reads", "exchange_bytes", "exchange_bytes_worstcase", "dropped")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scaling_lines():
    """(JAX lines, port lines) of the scaling probe at SCALING_ARGS."""
    from benchmarks import scaling as jscaling

    out, argv = io.StringIO(), sys.argv
    sys.argv = ["scaling", *map(str, SCALING_ARGS)]
    try:
        with contextlib.redirect_stdout(out):
            jscaling.main()
    finally:
        sys.argv = argv
    jlines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tlines = scaling.run(*SCALING_ARGS, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return jlines, tlines


@pytest.mark.parametrize("i,n", enumerate(scaling.MESH_SIZES))
def test_scaling_matches_jax(scaling_lines, i, n):
    jlines, tlines = scaling_lines
    want, got = jlines[i], tlines[i]
    assert got["mesh"] == want["mesh"] == n
    assert {f: got[f] for f in SCALING_FIELDS} == {f: want[f] for f in SCALING_FIELDS}
    assert got["dropped"] == 0 and got["step_ms"] > 0 and got["placement"] == ["cpu"] * n
    if n >= 4:  # the pre-pass sizes the cap below the worst case
        assert got["exchange_bytes"] < got["exchange_bytes_worstcase"]
    if n > 1:
        assert got["scaling_efficiency"] == got["gbps"] / (tlines[0]["gbps"] * n)


def test_scaling_summary_matches_jax(scaling_lines):
    jlines, tlines = scaling_lines
    (jsum,) = [ln["summary"] for ln in jlines if "summary" in ln]
    assert [r["mesh"] for r in jsum] == [r["mesh"] for r in tlines] == list(scaling.MESH_SIZES)
    assert all("scaling_efficiency" in r for r in tlines[1:])


def _jax_bigk_counts(codes: np.ndarray, k: int, m: int) -> np.ndarray:
    """benchmarks/bigk_probe.py's jnp_step."""
    from fastkmer_tpu.ops import count_sort, extract

    @jax.jit
    def jnp_step(c):
        ex = extract.extract(c, k, m, bigk_probe.B)
        ones = jnp.uint32(0xFFFFFFFF)
        cols = [jnp.where(ex.valid, ex.words[:, w], ones) for w in range(ex.words.shape[1])]
        return count_sort.count_presentineled(cols).counts

    return np.asarray(jnp_step(jnp.asarray(codes)))


@pytest.mark.parametrize("k,m", [(75, 12), (201, 14)])
def test_bigk_arms_match_jax(k, m):
    codes = np.random.default_rng(0).integers(0, 4, size=(8, 512), dtype=np.uint8)
    want = _jax_bigk_counts(codes, k, m)
    t = torch.from_numpy(codes)
    for step in (bigk_probe.plain_step, bigk_probe.kernel_step):
        np.testing.assert_array_equal(step(t, k, m).numpy().astype(np.int64),
                                      want.astype(np.int64))


def test_bigk_probe_on_cpu(one_thread):
    kms = ((75, 12), (201, 14))
    lines = bigk_probe.run(8, 512, kms=kms, device="cpu")
    assert [(x["k"], x["arm"]) for x in lines] == [
        (k, arm) for k, _ in kms for arm in ("plain", "kernel")]
    assert all(x["kernel_launches"] == 0 and x["ms"] > 0 and x["device"] == "cpu"
               for x in lines)  # on the CPU both arms are plain
    for plain, kern in zip(lines[::2], lines[1::2]):
        assert plain["n_unique"] == kern["n_unique"] > 0
        assert kern["W"] == -(-kern["k"] // 16) and kern["route"] == "staged"
        P = 512 - kern["k"] + 1
        assert kern["bound_ms"] == (8 * 512 + kern["W"] * 4 * 8 * P) / 3.35e12 * 1e3


def test_smer_probe_on_cpu(one_thread):
    lines = smer_pallas_probe.run(iters=1, R=16, L=512, device="cpu")
    assert [x.get("arm") for x in lines] == ["plain", "kernel", None]
    assert all(x["dropped"] == 0 and x["kernel_launches"] == 0 for x in lines[:2])
    assert lines[0]["n_unique"] == lines[1]["n_unique"] > 0
    assert lines[2]["speedup_kernel_over_plain"] == lines[0]["ms"] / lines[1]["ms"]
    # on the CPU both arms extract plainly: the kernel arm is the public step
    assert smer_pallas_probe.ARMS["kernel"] is exchange.build_distributed_count_smer


def test_smer_plain_arm_matches_jax(one_thread):
    from fastkmer_tpu.parallel import exchange as jx
    from fastkmer_tpu.parallel import partitioner as jpart

    k, m, B, smax = smer_pallas_probe.K, smer_pallas_probe.M, smer_pallas_probe.B, 64
    codes = smer_pallas_probe.make_reads(np.random.default_rng(0), 16, 512)
    cap = 16 * (512 - k + 1) // 3
    owner = jpart.hash_owner_map(B, 1)
    jmesh = jax.make_mesh((1,), (jx.AXIS,), devices=jax.devices("cpu")[:1])
    jsc = jx.build_distributed_count_smer(jmesh, k, m, B, cap, smax, owner, use_pallas=False)(
        jx.shard_batch(jmesh, codes))
    mesh = exchange.make_mesh(1, "cpu")
    tsc = smer_pallas_probe.ARMS["plain"](mesh, k, m, B, cap, smax, owner)(
        exchange.shard_batch(mesh, codes))
    assert int(tsc.dropped) == int(jsc.dropped) == 0
    ((tw, tc, tb),), ((jw, jc, jb),) = (exchange.compact_shard_counts(tsc),
                                        jx.compact_shard_counts(jsc))
    np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(tb, np.asarray(jb))


def test_pallas_sort_probe_on_cpu():
    lines = pallas_sort_probe.run(14, [1024, 2048], device="cpu")
    assert [x["measure"] for x in lines] == [
        "hw_exactness", "block_sort_1024", "block_sort_2048", "torch_sort_2key_1val"]
    assert lines[0]["keys_ok"] and lines[0]["vals_multiset_ok"]
    for x in lines[1:3]:
        assert {"marginal_ms", "ns_per_elem", "ns_per_elem_stage", "stages", "naive_ms",
                "kernel_ms", "bound_ms", "route", "cluster"} <= x.keys()
        assert x["bound_ms"] == (1 << 14) * 3 * 4 * 2 / 3.35e12 * 1e3
        assert x["stages"] == len(cuda_sort.stage_plan(3, int(x["measure"][11:])).stages)
    assert {"marginal_ms", "ns_per_elem", "naive_ms", "ms"} <= lines[3].keys()


def test_pallas_sort_probe_raises_on_a_wrong_sort(monkeypatch):
    """A mismatch of the kernel against its plain version raises."""
    def wrong(cols, num_keys, block):
        out = cuda_sort.sort_blocks_reference(cols, num_keys, block)
        return (out[0].flip(0),) + out[1:]

    monkeypatch.setattr(cuda_sort, "sort_blocks", wrong)
    with pytest.raises(RuntimeError, match="not exact"):
        pallas_sort_probe.run(12, [1024], device="cpu")


@pytest.mark.parametrize("lg", range(10, 18))
def test_block_sort_stages_match_jax(lg):
    """The probe's ``stages`` are the kernel plan's; they equal the JAX
    probe's ``n_stages``."""
    from benchmarks import pallas_sort_probe as jps

    block = 1 << lg
    assert len(cuda_sort.stage_plan(3, block).stages) == jps.n_stages(block)


@pytest.mark.parametrize("probe,argv", [
    (bigk_probe, ["1024"]),
    (bigk_probe, ["--iters", "2"]),
    (pallas_sort_probe, ["12", "--iters", "2"]),
])
def test_probe_cli_takes_the_jax_arguments_only(probe, argv, capsys):
    with pytest.raises(SystemExit):
        probe.main(argv + ["--device", "cpu"])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_pallas_sort_probe_cli_on_cpu(capsys):
    pallas_sort_probe.main(["12", "1024", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["measure"] for x in lines] == [
        "hw_exactness", "block_sort_1024", "torch_sort_2key_1val"]
    assert all(x["rows"] == 1 << 12 and x["device"] == "cpu" for x in lines)
