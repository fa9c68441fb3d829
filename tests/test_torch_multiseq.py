"""Multisequence counting in fastkmer_tpu_torch (``multiseq``) vs
fastkmer_tpu's on the CPU, on one seeded multi-FASTA: four sequences that
share k-mers (reads of one backbone with 1% substitutions), headers
``S<s>.<i>``, Ns.

Single device, both paths (the host path's per-batch parts, and the
accumulator with or without ``unique_ub``) at k = 28, 32 (kernel A's flag
lane) and 55: the same (k-mer, seq) table and sequence names, exactly, and
byte-identical bin files, ``distances.json`` and manifest (``counts.npz`` by
its members).  Distances of every measure, the non-sum plug-ins included,
to 1e-12 relative on the host path; the device Gram (its plain torch form
on the CPU) to 1e-4 of JAX's.  Durability: verify, tamper, kill and
resume; a checkpoint an interrupted JAX run left behind resumes in the
port; SRA-style tags; repair of a damaged bin from the sidecar and by a
recount, across the two packages.  The mesh runs are in
``test_torch_multiseq_mesh.py``.  Each JAX job runs once per module."""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402

from fastkmer_tpu import pipeline as jpipe  # noqa: E402
from fastkmer_tpu.ingest import batch as jbatch  # noqa: E402
from fastkmer_tpu.multiseq import distances as jdm  # noqa: E402
from fastkmer_tpu.multiseq import pipeline as jms  # noqa: E402
from fastkmer_tpu.output import manifest as jman  # noqa: E402
from fastkmer_tpu_torch import pipeline as tpipe  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as tbatch  # noqa: E402
from fastkmer_tpu_torch.multiseq import distances as tdm  # noqa: E402
from fastkmer_tpu_torch.multiseq import pipeline as tms  # noqa: E402
from fastkmer_tpu_torch.output import manifest as tman  # noqa: E402

from . import test_multiseq as jtests  # noqa: E402
from .test_torch_cli import _dir_bytes  # noqa: E402
from .test_torch_pipeline import _npz_members  # noqa: E402

# k, m, the measure of the directory comparison
KS = {28: (8, "multisequence.SquaredEuclidean"), 32: (9, "multisequence.KLDLog2"),
      55: (9, "multisequence.KLDLogN")}
MEASURES = ["multisequence.SquaredEuclidean", "multisequence.KLDLog2", "multisequence.KLDLogN"]


def write_multiseq_fasta(path: str, seed: int, n_seq: int = 4, n_reads: int = 30) -> None:
    """Reads of a 400-base backbone (1% substitutions, so the sequences
    share most k-mers and differ in a few) and random reads with ~4% N,
    headers ``S<s>.<i>``, the sequences one after another."""
    rng = np.random.default_rng(seed)
    backbone = rng.choice(list("ACGT"), size=400)
    with open(path, "w") as f:
        for s in range(n_seq):
            for i in range(n_reads):
                if rng.random() < 0.5:
                    st = int(rng.integers(0, 250))
                    r = backbone[st : st + 150].copy()
                else:
                    r = rng.choice(list("ACGTN"), p=[0.24] * 4 + [0.04],
                                   size=int(rng.integers(60, 150)))
                sub = rng.random(r.size) < 0.01
                r[sub] = rng.choice(list("ACGT"), size=int(sub.sum()))
                f.write(f">S{s}.{i} read\n{''.join(r)}\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiseq")
    fa = str(d / "in.fa")
    write_multiseq_fasta(fa, 7)
    return d, fa


def _kw(d, fa, k, prefix="ms_", **kw):
    m, measure = KS[k]
    base = dict(dataset=fa, output_directory=str(d) + "/", prefix=prefix, k=k, m=m, max_b=64,
                reads_per_batch=8, read_len=256, distance_measure=measure)
    return {**base, **kw}


_JAX = {}


def _jax_run(data, k, kryo=False):
    """The JAX host path's run at k (text or binary output): (result, the
    directory's bytes), made once per module."""
    key = (k, kryo)
    if key not in _JAX:
        d, fa = data
        cfg = jms.MultiseqConfig(**_kw(d, fa, k, use_kryo_serializer=kryo))
        res = jms.execute_multiseq_job(cfg, verbose=False, device_accumulate=False)
        _JAX[key] = res, _dir_bytes(cfg.output_dir)
        shutil.rmtree(cfg.output_dir)
    return _JAX[key]


def _assert_results_equal(got, want):
    for f in ("words", "seqs", "counts", "bins"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert got.sequence_names == want.sequence_names
    assert got.n_instances == want.n_instances
    assert got.distances.keys() == want.distances.keys()
    for pair, dist in want.distances.items():
        assert got.distances[pair] == pytest.approx(dist, rel=1e-12, abs=0), pair


class TestMeasures:
    @pytest.mark.parametrize("name", MEASURES)
    def test_measure_is_the_jax_one(self, name):
        """partial and bilinear_terms (numpy) equal JAX's; the torch row
        terms equal the jnp ones to float32 precision."""
        import jax.numpy as jnp

        t, j = tdm.get_measure(name), jdm.get_measure(name)
        assert (t.name, t.symmetric, t.operator_kind) == (j.name, j.symmetric, j.operator_kind)
        rng = np.random.default_rng(3)
        c1 = rng.integers(0, 9, size=200).astype(np.float64)
        c2 = rng.integers(0, 9, size=200).astype(np.float64)
        np.testing.assert_array_equal(t.partial(c1, c2), j.partial(c1, c2))
        C = rng.integers(0, 9, size=(40, 6)).astype(np.float64)
        for (tf, tg), (jf, jg) in zip(t.bilinear_terms(C), j.bilinear_terms(C)):
            np.testing.assert_array_equal(tf, jf)
            np.testing.assert_array_equal(tg, jg)
        c = rng.integers(1, 3000, size=300).astype(np.float32)
        for (tf, tg), (jf, jg) in zip(t.bilinear_row_terms(torch.from_numpy(c)),
                                      j.bilinear_row_terms(jnp.asarray(c))):
            np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)

    def test_registry(self):
        assert set(tdm.MEASURES) == set(jdm.MEASURES)
        for alias, name in (("squared_euclidean", MEASURES[0]), ("kld_log2", MEASURES[1]),
                            ("kld_logn", MEASURES[2])):
            assert tdm.get_measure(alias) is tdm.MEASURES[name]
        m = tdm.KLDLog2()
        assert tdm.get_measure(m) is m
        v = tdm.DistanceMeasure.normalized_values(10.0, 101, 20.0, 51, 2)
        assert v == jdm.DistanceMeasure.normalized_values(10.0, 101, 20.0, 51, 2)


@pytest.mark.parametrize("path", ["host", "accumulator", "unique_ub"])
@pytest.mark.parametrize("k", sorted(KS))
def test_single_device_matches_jax(data, k, path):
    """The host path, the accumulator and its sync-free feed give the JAX
    table, names and distances, and write its directory byte for byte."""
    d, fa = data
    want, want_dir = _jax_run(data, k)
    cfg = tms.MultiseqConfig(**_kw(d, fa, k))
    got = tms.execute_multiseq_job(
        cfg, verbose=False, device="cpu", device_accumulate=path != "host",
        unique_ub=1 << 16 if path == "unique_ub" else None,
    )
    _assert_results_equal(got, want)
    assert got.n_batches > 4
    assert set(got.timings) == {"device_count", "merge", "distances", "write_output"}
    assert _dir_bytes(cfg.output_dir) == want_dir
    assert sorted(want_dir)[-2:] == ["distances.json", "manifest.json"]
    shutil.rmtree(cfg.output_dir)


def test_binary_output_matches_jax(data):
    """enableKryo: counts.npz's members, distances.json and the manifest
    but for the npz's own hash are JAX's."""
    d, fa = data
    _, want = _jax_run(data, 28, kryo=True)
    cfg = tms.MultiseqConfig(**_kw(d, fa, 28, use_kryo_serializer=True))
    tms.execute_multiseq_job(cfg, verbose=False, device="cpu")
    got = _dir_bytes(cfg.output_dir)
    assert sorted(got) == sorted(want) == ["counts.npz", "distances.json", "manifest.json"]
    assert _npz_members(got["counts.npz"]) == _npz_members(want["counts.npz"])
    assert got["distances.json"] == want["distances.json"]
    tm, jm = json.loads(got["manifest.json"]), json.loads(want["manifest.json"])
    tm["extra_files"].pop("counts.npz")
    jm["extra_files"].pop("counts.npz")
    assert tm == jm
    assert tman.verify_output(cfg.output_dir)["ok"]
    shutil.rmtree(cfg.output_dir)


class TToyProduct(tdm.DistanceMeasure):
    """The port's twin of test_multiseq.ToyProduct (a product operator)."""

    name = "test.ToyProduct"
    operator_kind = "product"
    init_distance = jtests.ToyProduct.init_distance
    operator = jtests.ToyProduct.operator
    partial = jtests.ToyProduct.partial


class TToyMax(tdm.DistanceMeasure):
    """The port's twin of test_multiseq.ToyMax (a max fold)."""

    name = "test.ToyMax"
    operator_kind = "max"
    init_distance = jtests.ToyMax.init_distance
    operator = jtests.ToyMax.operator
    partial = jtests.ToyMax.partial


def _generic_only(measure):
    """``measure`` without its Gram fast paths: the generic sweep."""

    class GenericOnly(type(measure)):
        def bilinear_terms(self, C):
            return None

        def bilinear_row_terms(self, c):
            return None

    return GenericOnly()


MEASURE_PAIRS = {name: (lambda n=name: (tdm.get_measure(n), jdm.get_measure(n)))
                 for name in MEASURES}
MEASURE_PAIRS["ToyProduct"] = lambda: (TToyProduct(), jtests.ToyProduct())
MEASURE_PAIRS["ToyMax"] = lambda: (TToyMax(), jtests.ToyMax())


def _random_table(rng, S, n_kmers, p, hi):
    rows = [(g, s, int(rng.integers(1, hi))) for g in range(n_kmers)
            for s in np.flatnonzero(rng.random(S) < p)]
    gid = np.array([r[0] for r in rows], np.int64)
    words = np.stack([gid.astype(np.uint32), (gid * 7 + 1).astype(np.uint32)], 1)
    return (gid, words, np.array([r[1] for r in rows], np.int32),
            np.array([r[2] for r in rows], np.int64))


@pytest.mark.parametrize("name", list(MEASURE_PAIRS))
def test_host_distances_match_jax(data, name):
    """accumulate_distances on the host: every measure (the Gram fast path,
    the generic sweep, the non-sum folds) on the job's own table and on
    random tables with S past the group block quantum, to 1e-12 of JAX."""
    t, j = MEASURE_PAIRS[name]()
    res, _ = _jax_run(data, 28)
    S = len(res.sequence_names)
    # a product of 1 + c1·c2 over every k-mer overflows: 60 rows of the table
    rows = slice(None) if t.operator_kind != "product" else slice(60)
    tables = [(res.words[rows], res.seqs[rows], res.counts[rows], S)]
    rng = np.random.default_rng(99)
    shapes = ((3, 12), (17, 60), (64, 40)) if t.operator_kind == "sum" else ((3, 12), (6, 30))
    for S2, n_kmers in shapes:
        _, words, seqs, counts = _random_table(rng, S2, n_kmers, 0.3, 9)
        tables.append((words, seqs, counts, S2))
    for words, seqs, counts, S2 in tables:
        want = jms.accumulate_distances(words, seqs, counts, S2, j)
        got = tms.accumulate_distances(words, seqs, counts, S2, t)
        assert np.isfinite(want[~np.eye(S2, dtype=bool)]).all()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        if t.operator_kind == "sum":
            np.testing.assert_allclose(
                tms.accumulate_distances(words, seqs, counts, S2, _generic_only(t)),
                jms.accumulate_distances(words, seqs, counts, S2, _generic_only(j)),
                rtol=1e-12, atol=0)
    want = jms.accumulate_distances(res.words[:0], res.seqs[:0], res.counts[:0], S, j)
    np.testing.assert_array_equal(
        tms.accumulate_distances(res.words[:0], res.seqs[:0], res.counts[:0], S, t), want)


@pytest.mark.parametrize("name", MEASURES)
def test_device_pair_sums_match_jax(name):
    """The device Gram (torch on the CPU here) against JAX's jitted one to
    1e-4 (JAX's runs in float32, the port's in float64), including groups
    across the T-row block boundary and wide S; and
    accumulate_distances(device="cpu") against the host path to 1e-9."""
    t, j = tdm.get_measure(name), jdm.get_measure(name)
    rng = np.random.default_rng(101)
    for S, n_kmers in ((3, 50), (16, 900), (48, 300)):
        gid, words, seqs, counts = _random_table(rng, S, n_kmers, 0.5, 50)
        want = jms._pair_sums_from_device(gid, seqs, counts.astype(np.float64), S, j)
        got = tms._pair_sums_from_device(gid, seqs, counts.astype(np.float64), S, t,
                                         device="cpu")
        assert got.dtype == np.float64 and got.shape == (S, S)
        # the diagonal of the KLD pair sums cancels to float32 noise in both
        # (f(c) g(c) = c log c - c log c): absolute 1e-4 of the largest sum
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
        host = tms.accumulate_distances(words, seqs, counts, S, t)
        dev = tms.accumulate_distances(words, seqs, counts, S, t, device="cpu")
        np.testing.assert_allclose(dev, host, rtol=1e-9, atol=1e-9 * np.abs(host).max())


def test_device_pair_sums_block_boundary_group():
    """A group laid exactly across the T = 2048 block boundary is paired
    once; the process-wide float32 matmul precision is left as it was."""
    measure = tdm.get_measure(MEASURES[0])
    S = 4
    gid = np.concatenate([np.arange(2047), np.full(S, 2047)])
    words = np.stack([gid.astype(np.uint32), (gid + 1).astype(np.uint32)], 1)
    seqs = np.concatenate([np.zeros(2047, np.int32), np.arange(S, dtype=np.int32)])
    counts = np.concatenate([np.full(2047, 2, np.int64), np.arange(1, S + 1, dtype=np.int64)])
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        dev = tms.accumulate_distances(words, seqs, counts, S, measure, device="cpu")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    host = tms.accumulate_distances(words, seqs, counts, S, measure)
    np.testing.assert_allclose(dev, host, rtol=1e-6, atol=1e-8)
    want = jms.accumulate_distances(words, seqs, counts, S, jdm.get_measure(MEASURES[0]),
                                    device=True)
    np.testing.assert_allclose(dev, want, rtol=1e-6, atol=1e-8)


def _dying(real, at: int, call: int = 0):
    """A batch reader that raises KeyboardInterrupt as its ``call``-th use
    (0-based) is about to yield batch ``at``."""
    calls = []

    def reader(*a, **kw):
        fatal = len(calls) == call
        calls.append(1)
        for i, b in enumerate(real(*a, **kw)):
            if fatal and i == at:
                raise KeyboardInterrupt
            yield b

    return reader


@pytest.mark.parametrize("path", ["host", "accumulator"])
def test_verify_tamper_resume(data, tmp_path, monkeypatch, path):
    """A multiseq directory verifies (bins and the distances.json hash); a
    tampered distances.json is caught; a run killed after 3 batches resumes
    from its checkpoints to the uninterrupted result, which is JAX's, and
    its rewrite heals the tamper."""
    d, fa = data
    want, want_dir = _jax_run(data, 28)
    cfg = tms.MultiseqConfig(**_kw(tmp_path, fa, 28))
    acc = path == "accumulator"
    tms.execute_multiseq_job(cfg, verbose=False, device="cpu", device_accumulate=acc)
    assert tman.verify_output(cfg.output_dir)["ok"]
    before = _dir_bytes(cfg.output_dir)
    assert {n: b for n, b in before.items() if n != "manifest.json"} == {
        n: b for n, b in want_dir.items() if n != "manifest.json"}
    with open(os.path.join(cfg.output_dir, "distances.json"), "a") as f:
        f.write(" ")
    status = tman.verify_output(cfg.output_dir)
    assert not status["ok"] and status["extra_mismatched"] == ["distances.json"]
    ck = str(tmp_path / "ck")
    run = dict(verbose=False, device="cpu", device_accumulate=acc, checkpoint_dir=ck,
               checkpoint_interval=2)
    monkeypatch.setattr(tbatch, "batch_codes_dense_tagged",
                        _dying(tbatch.batch_codes_dense_tagged, 3))
    with pytest.raises(KeyboardInterrupt):
        tms.execute_multiseq_job(cfg, **run)
    monkeypatch.undo()
    assert tman.BatchCheckpointer(ck).completed_batches() == (2 if acc else 3)
    res = tms.execute_multiseq_job(cfg, **run)
    _assert_results_equal(res, want)
    assert os.listdir(ck) == []
    assert _dir_bytes(cfg.output_dir) == before


@pytest.mark.parametrize("accumulate", [False, True])
def test_jax_checkpoint_resumes_in_the_port(data, tmp_path, monkeypatch, accumulate):
    """The checkpoint directory of a JAX multiseq run killed after 3
    batches (per-batch parts with the seq lane, or accumulator spills)
    resumes in the port to JAX's uninterrupted result."""
    d, fa = data
    want, _ = _jax_run(data, 28)
    ck = str(tmp_path / "ck")
    run = dict(verbose=False, device_accumulate=accumulate, checkpoint_dir=ck,
               checkpoint_interval=2)
    jcfg = jms.MultiseqConfig(**_kw(tmp_path, fa, 28, write=False))
    monkeypatch.setattr(jbatch, "batch_codes_dense_tagged",
                        _dying(jbatch.batch_codes_dense_tagged, 3))
    with pytest.raises(KeyboardInterrupt):
        jms.execute_multiseq_job(jcfg, **run)
    monkeypatch.undo()
    assert jman.BatchCheckpointer(ck).completed_batches() == (2 if accumulate else 3)
    got = tms.execute_multiseq_job(tms.MultiseqConfig(**_kw(tmp_path, fa, 28, write=False)),
                                   device="cpu", **run)
    _assert_results_equal(got, want)
    assert os.listdir(ck) == []


def test_sra_accession_tagging(tmp_path):
    """SRR197985.1 / SRR197985.2 tag one sequence, as the reference's
    ``(\\w+).`` extraction does; the tag function is JAX's."""
    fa = str(tmp_path / "sra.fa")
    with open(fa, "w") as f:
        f.write(">SRR197985.1 HWUSI len=20\nACGTACGTACGTACGTACGT\n")
        f.write(">SRR956987.1 HWI len=20\nTTTTGGGGCCCCAAAATTTT\n")
        f.write(">SRR197985.2 HWUSI len=20\nACGTACGTACGTACGTACGT\n")
    cfg = tms.MultiseqConfig(dataset=fa, output_directory=str(tmp_path) + "/", k=8, m=4,
                             max_b=16, reads_per_batch=4, read_len=64, write=False)
    res = tms.execute_multiseq_job(cfg, verbose=False, device="cpu")
    assert res.sequence_names == ["SRR197985", "SRR956987"]
    for h in ("SRR197985.1 HWUSI", "S3.12 read", "chr1#2", "-odd name", "a_b.c d", "x#0 y"):
        assert tms._sequence_tag(h) == jms._sequence_tag(h), h


def test_product_measure_end_to_end(tmp_path):
    """A product plug-in through the whole job: the distances are JAX's."""
    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        f.write(">a.1\nACGTACGTACGTAC\n>b.1\nTTGTACGTACGAAC\n>c.1\nACGTACGAACGTTT\n")
    kw = dict(dataset=fa, output_directory=str(tmp_path) + "/", k=8, m=4, max_b=16,
              reads_per_batch=2, read_len=32, write=False)
    want = jms.execute_multiseq_job(jms.MultiseqConfig(**kw, distance_measure=jtests.ToyProduct()),
                                    verbose=False, device_accumulate=False)
    got = tms.execute_multiseq_job(tms.MultiseqConfig(**kw, distance_measure=TToyProduct()),
                                   verbose=False, device="cpu")
    _assert_results_equal(got, want)


def _damage_a_bin(out: str) -> str:
    victim = sorted(n for n in os.listdir(out) if n.startswith("bin"))[1]
    with open(os.path.join(out, victim), "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(b"A" if first != b"A" else b"C")
    assert not tman.verify_output(out)["ok"]
    return victim


@pytest.mark.parametrize("keep_table", [False, True])
def test_repair_multiseq_directory(data, tmp_path, monkeypatch, keep_table):
    """One damaged bin of a multiseq directory is rewritten byte for byte:
    from the table.npz sidecar with no recount, or by a count-job recount,
    whose per-k-mer sums are the multiseq bins.  A damaged distances.json is
    reported and left as it is."""
    d, fa = data
    cfg = tms.MultiseqConfig(**_kw(tmp_path, fa, 28))
    tms.execute_multiseq_job(cfg, verbose=False, device="cpu", keep_table=keep_table)
    before = _dir_bytes(cfg.output_dir)
    assert (tman.TABLE_SIDECAR in before) == keep_table
    _damage_a_bin(cfg.output_dir)
    recounts = []
    real = tpipe.execute_job
    monkeypatch.setattr(tpipe, "execute_job", lambda *a, **kw: recounts.append(1) or real(*a, **kw))
    status = tpipe.repair_output(cfg, verbose=False, device="cpu")
    assert status["ok"], status
    assert _dir_bytes(cfg.output_dir) == before
    assert len(recounts) == (0 if keep_table else 1)
    dpath = os.path.join(cfg.output_dir, "distances.json")
    with open(dpath, "a") as f:
        f.write(" ")
    status = tpipe.repair_output(cfg, verbose=False, device="cpu")
    assert not status["ok"] and status["extra_mismatched"] == ["distances.json"]
    assert open(dpath, "rb").read() == before["distances.json"] + b" "


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecar_repairs_the_other_package(data, tmp_path, writer):
    """A multiseq directory with its table.npz written by one package and a
    damaged bin is repaired by the other's repair_output from the sidecar."""
    d, fa = data
    kw = _kw(tmp_path, fa, 28)
    if writer == "jax":
        cfg = jms.MultiseqConfig(**kw)
        jms.execute_multiseq_job(cfg, verbose=False, device_accumulate=False, keep_table=True)
    else:
        cfg = tms.MultiseqConfig(**kw)
        tms.execute_multiseq_job(cfg, verbose=False, device="cpu", keep_table=True)
    before = _dir_bytes(cfg.output_dir)
    _damage_a_bin(cfg.output_dir)
    if writer == "jax":
        status = tpipe.repair_output(tms.MultiseqConfig(**kw), verbose=False, device="cpu")
    else:
        status = jpipe.repair_output(jms.MultiseqConfig(**kw), verbose=False)
    assert status["ok"], status
    assert _dir_bytes(cfg.output_dir) == before


def test_config_from_manifest_rebuilds_the_multiseq_config(data, tmp_path):
    d, fa = data
    cfg = tms.MultiseqConfig(**_kw(tmp_path, fa, 32))
    tms.execute_multiseq_job(cfg, verbose=False, device="cpu")
    with open(os.path.join(cfg.output_dir, tman.MANIFEST)) as f:
        got = tpipe.config_from_manifest(json.load(f)["config"])
    assert got == cfg and type(got) is tms.MultiseqConfig
