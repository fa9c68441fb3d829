"""Multisequence counting on the streaming mesh: fastkmer_tpu_torch's
``multiseq.distributed`` on 4 CPU shards vs fastkmer_tpu's on a JAX mesh of
4 virtual CPU devices, on ``test_torch_multiseq.py``'s multi-FASTA.

At k = 28 (LPT placement, ``useCustomPartitioner=1 4``), 32 (hash
placement; the seq lane alone keeps the sentinel unambiguous) and 55
(LPT): the same (k-mer, seq) table, sequence names and distances,
``exchange_bytes`` and balance, and byte-identical bin files,
``distances.json`` and manifest; the mesh's table equals the single
device's.  A mesh run killed mid-way resumes to the uninterrupted
directory, and the reference's multi-process error is kept.  Each JAX job
runs once per module."""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from fastkmer_tpu.multiseq import distributed as jmd  # noqa: E402
from fastkmer_tpu.multiseq import pipeline as jms  # noqa: E402
from fastkmer_tpu.parallel import exchange as jx  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as tbatch  # noqa: E402
from fastkmer_tpu_torch.multiseq import distributed as tmd  # noqa: E402
from fastkmer_tpu_torch.multiseq import pipeline as tms  # noqa: E402
from fastkmer_tpu_torch.output import manifest as tman  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange as tx  # noqa: E402

from .test_torch_cli import _dir_bytes  # noqa: E402
from .test_torch_multiseq import _assert_results_equal, _dying, _kw  # noqa: E402
from .test_torch_multiseq import write_multiseq_fasta  # noqa: E402

N = 4
PLACEMENT = {28: True, 32: False, 55: True}  # use_custom_partitioner (LPT) per k


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiseq_mesh")
    fa = str(d / "in.fa")
    write_multiseq_fasta(fa, 7)
    return d, fa


@pytest.fixture(scope="module")
def meshes():
    return (jax.make_mesh((N,), (jx.AXIS,), devices=jax.devices("cpu")[:N]),
            tx.make_mesh(N, "cpu"))


def _mesh_kw(d, fa, k, **kw):
    lpt = PLACEMENT[k]
    return _kw(d, fa, k, prefix="mesh_", use_custom_partitioner=lpt,
               num_partition_tasks=4 if lpt else 0, **kw)


_JAX = {}


def _jax_run(data, meshes, k):
    """JAX's distributed multiseq at k: (result, the directory's bytes)."""
    if k not in _JAX:
        d, fa = data
        cfg = jms.MultiseqConfig(**_mesh_kw(d, fa, k))
        res = jmd.execute_multiseq_job_distributed(cfg, meshes[0], verbose=False)
        _JAX[k] = res, _dir_bytes(cfg.output_dir)
        shutil.rmtree(cfg.output_dir)
    return _JAX[k]


@pytest.mark.parametrize("k", sorted(PLACEMENT))
def test_mesh_matches_jax(data, meshes, k):
    d, fa = data
    want, want_dir = _jax_run(data, meshes, k)
    cfg = tms.MultiseqConfig(**_mesh_kw(d, fa, k))
    got = tmd.execute_multiseq_job_distributed(cfg, meshes[1], verbose=False)
    _assert_results_equal(got, want)
    assert got.exchange_bytes == want.exchange_bytes > 0
    assert got.balance == want.balance
    assert ("imbalance" in got.balance) == PLACEMENT[k]
    assert _dir_bytes(cfg.output_dir) == want_dir
    shutil.rmtree(cfg.output_dir)
    single = tms.execute_multiseq_job(tms.MultiseqConfig(**_kw(d, fa, k, write=False)),
                                      verbose=False, device="cpu")
    _assert_results_equal(got, single)
    assert got.n_batches == single.n_batches


def test_mesh_prededup_and_sync_free(data, meshes):
    """The dedup transport (forced) and the sync-free feed give the same
    result as JAX's default run."""
    d, fa = data
    want, _ = _jax_run(data, meshes, 28)
    for kw in ({"prededup": True}, {"prededup": False, "unique_ub": 1 << 16}):
        got = tmd.execute_multiseq_job_distributed(
            tms.MultiseqConfig(**_mesh_kw(d, fa, 28, write=False)), meshes[1], verbose=False,
            **kw)
        _assert_results_equal(got, want)


def test_mesh_resume(data, meshes, tmp_path, monkeypatch):
    """Killed after 3 batches of the main pass (the LPT pre-pass reads the
    file first), a mesh run resumes from its spill checkpoint to the
    uninterrupted directory; the checkpoint directory is emptied."""
    d, fa = data
    want, want_dir = _jax_run(data, meshes, 28)
    cfg = tms.MultiseqConfig(**_mesh_kw(d, fa, 28))
    ck = str(tmp_path / "ck")
    run = dict(verbose=False, checkpoint_dir=ck, checkpoint_interval=2)
    monkeypatch.setattr(tbatch, "batch_codes_dense_tagged",
                        _dying(tbatch.batch_codes_dense_tagged, 3, call=1))
    with pytest.raises(KeyboardInterrupt):
        tmd.execute_multiseq_job_distributed(cfg, meshes[1], **run)
    monkeypatch.undo()
    assert tman.BatchCheckpointer(ck).completed_batches() == 2
    got = tmd.execute_multiseq_job_distributed(cfg, meshes[1], **run)
    _assert_results_equal(got, want)
    assert os.listdir(ck) == []
    assert _dir_bytes(cfg.output_dir) == want_dir
    shutil.rmtree(cfg.output_dir)


def test_mesh_refuses_several_processes(data, meshes, monkeypatch):
    """With torch.distributed initialised over more than one rank the mesh
    job raises (JAX's error for more than one process)."""
    d, fa = data
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **kw: 2)
    with pytest.raises(NotImplementedError, match="single-process mesh"):
        tmd.execute_multiseq_job_distributed(
            tms.MultiseqConfig(**_mesh_kw(d, fa, 28)), meshes[1], verbose=False)
    assert not os.path.exists(tms.MultiseqConfig(**_mesh_kw(d, fa, 28)).output_dir)


def test_mesh_table_ascends_by_sequence_within_a_kmer(data, meshes):
    """Rows of one k-mer ascend by sequence id: the seq lane sorts as an
    unsigned key below the all-ones sentinel."""
    d, fa = data
    got = tmd.execute_multiseq_job_distributed(
        tms.MultiseqConfig(**_mesh_kw(d, fa, 32, write=False)), meshes[1], verbose=False)
    same = np.all(got.words[1:] == got.words[:-1], axis=1)
    assert same.any()
    assert (got.seqs[1:][same] > got.seqs[:-1][same]).all()
    assert got.seqs.min() >= 0 and got.seqs.max() < len(got.sequence_names)
