"""The HT engine (useHT=1) of fastkmer_tpu_torch vs fastkmer_tpu, both on
the CPU: ``execute_job`` output directories byte-identical at k = 25, 32
and 55 (no ``EOF`` line), the HT table equal to the sort engine's on the
single device and the mesh, the ``single-ht`` and ``mesh-ht`` rows of
``test_flag_matrix.py`` through both CLIs, and the reference's errors for
``unique_ub`` and a forced prededup under the hash engine.

At W >= 3 words (k > 32) the JAX host merge takes each batch's
fingerprint-ordered HT table for a k-mer-ordered one, so its table is
wrong once a k-mer recurs across batches (ROADMAP §3).  The port sorts
those rows into k-mer order; at k = 55 it is held against JAX's HT engine
on one batch and against JAX's sort engine on many.  Integer outputs, so
the tolerance is bit-equality."""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from fastkmer_tpu import cli as jcli  # noqa: E402
from fastkmer_tpu import pipeline as jpipe  # noqa: E402
from fastkmer_tpu.config import JobConfig  # noqa: E402
from fastkmer_tpu_torch import cli as tcli  # noqa: E402
from fastkmer_tpu_torch import pipeline as tpipe  # noqa: E402
from fastkmer_tpu_torch.parallel import driver as tdriver  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange as tx  # noqa: E402

from . import oracles  # noqa: E402
from .test_pipeline_e2e import result_as_dict, write_fasta  # noqa: E402
from .test_torch_cli import _dir_bytes  # noqa: E402
from .test_torch_pipeline import _assert_tables_equal, mixed_reads  # noqa: E402

# (k, m, reads a batch): k = 55 on one batch, where the JAX HT table is right
CASES = [(25, 8, 16), (32, 9, 16), (55, 8, 512)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ht")
    reads = mixed_reads(23, n=60)
    fa = str(d / "in.fa")
    write_fasta(fa, reads)
    return d, fa, reads


def _cfg(d, fa, k, m, rpb, **kw):
    return JobConfig(dataset=fa, output_directory=str(d) + "/", prefix="ht_", k=k, m=m,
                     max_b=64, reads_per_batch=rpb, read_len=256, use_ht=True, **kw)


@pytest.fixture(scope="module")
def jax_dirs(data):
    """The JAX HT engine's output directory for each case, made once."""
    d, fa, _ = data
    out = {}
    for k, m, rpb in CASES:
        cfg = _cfg(d, fa, k, m, rpb)
        res = jpipe.execute_job(cfg, verbose=False)
        out[k] = (res, _dir_bytes(cfg.output_dir))
    return out


@pytest.mark.parametrize("k,m,rpb", CASES)
def test_ht_output_dirs_identical(data, jax_dirs, k, m, rpb):
    d, fa, reads = data
    cfg = _cfg(d, fa, k, m, rpb)
    jres, want = jax_dirs[k]
    res = tpipe.execute_job(cfg, verbose=False, device="cpu")
    got = _dir_bytes(cfg.output_dir)
    assert got == want
    _assert_tables_equal(res, jres)
    bins = [b for n, b in got.items() if n.startswith("bin")]
    assert bins and not any(b.endswith(b"EOF") for b in bins)
    assert result_as_dict(res, k) == dict(oracles.count_reads(reads, k))
    assert res.n_batches >= (2 if rpb == 16 else 1)


@pytest.mark.parametrize("k,m", [(28, 10), (55, 8)])
def test_ht_table_equals_sort_table(data, k, m):
    """The counterpart of test_pipeline_e2e.py's cross-engine equality, on
    many batches of duplication-heavy reads, single device and mesh: the
    HT engine's table is the sort engine's, and the JAX sort engine's."""
    d, fa, reads = data
    base = dict(dataset=fa, output_directory=str(d) + "/", k=k, m=m, max_b=64,
                reads_per_batch=8, read_len=256, write=False)
    sort = tpipe.execute_job(JobConfig(**base), verbose=False, device="cpu")
    ht = tpipe.execute_job(JobConfig(**base, use_ht=True), verbose=False, device="cpu")
    _assert_tables_equal(ht, sort)
    assert ht.n_batches > 4
    jsort = jpipe.execute_job(JobConfig(**base), verbose=False)
    _assert_tables_equal(ht, jsort)
    mesh = tdriver.execute_job_distributed(JobConfig(**base, use_ht=True),
                                           tx.make_mesh(3, "cpu"), verbose=False)
    for got, want in zip(mesh[:3], sort[:3]):
        np.testing.assert_array_equal(got, want)
    assert result_as_dict(ht, k) == dict(oracles.count_reads(reads, k))
    if k > 32:
        # the reference's fault: the JAX HT table keeps a k-mer that recurs
        # across batches as several rows (ROADMAP §3)
        jht = jpipe.execute_job(JobConfig(**base, use_ht=True), verbose=False)
        assert len(jht.counts) > len(jsort.counts)


@pytest.mark.parametrize("path", ["single-ht", "mesh-ht"])
def test_flag_matrix_ht_rows_through_both_clis(tmp_path, path):
    """test_flag_matrix.py's data and arguments for its single-ht and
    mesh-ht paths: identical output directories and the summary's engine."""
    rng = np.random.default_rng(42)
    reads = ["".join(rng.choice(list("ACGT"), size=120)) for _ in range(16)]
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">s{i % 3}.{i}\n{r}\n")
    out = str(tmp_path) + "/"
    argv = ["25", "8", "3", "32", "1", "0", fa, out, "fm_", "1", "0", "0",
            "--reads-per-batch", "8", "--read-len", "128"]
    if path == "mesh-ht":
        argv += ["--mesh", "4"]
    d = os.path.join(out, "fm_k25_m8_x3_b32_s0")
    assert jcli.main(argv + ["--platform", "cpu"]) == 0
    want = _dir_bytes(d)
    shutil.rmtree(d)
    stats = str(tmp_path / "stats.json")
    assert tcli.main(argv + ["--device", "cpu", "--stats-json", stats]) == 0
    assert _dir_bytes(d) == want
    summary = json.load(open(stats))
    assert summary["engine"] == "hash" and "PERF.md" in summary["engine_note"]
    assert summary["n_instances"] == sum(oracles.count_reads(reads, 25).values())


@pytest.mark.parametrize("kw,msg", [({"unique_ub": 1 << 20}, "unique_ub"),
                                    ({"prededup": True}, "prededup")])
def test_ht_errors_match_jax(data, kw, msg):
    d, fa, _ = data
    cfg = _cfg(d, fa, 28, 10, 16, write=False)
    with pytest.raises(NotImplementedError, match=msg):
        jpipe.execute_job(cfg, verbose=False, **kw)
    with pytest.raises(NotImplementedError, match=msg):
        tpipe.execute_job(cfg, verbose=False, device="cpu", **kw)
