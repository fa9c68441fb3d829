"""Job durability in fastkmer_tpu_torch vs fastkmer_tpu, both on the CPU:
the counterparts of ``tests/test_manifest.py``.  Kill-and-resume on the
host path, on the device accumulator, on the streaming mesh and on the
per-batch mesh (super-k-mer transport and the HT engine): each resumed
output is byte-identical to an uninterrupted JAX run's, and the
checkpoint directory is emptied.  A checkpoint directory that an
interrupted JAX run left behind resumes in the port to the same table,
and one the host path wrote per batch resumes in the accumulator.
Then verification and repair: binary outputs (and ``api.load_binary``),
the binary repair guards,
reruns that clean stale outputs, ``rollback_to``, ``repair_output`` from
a recount and from the table sidecar (no recount), content corruption,
and a repair that takes its config from the manifest.  Each JAX run is
made once per module.  Integer outputs, so the tolerance is equality."""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from fastkmer_tpu import api as japi  # noqa: E402
from fastkmer_tpu import pipeline as jpipe  # noqa: E402
from fastkmer_tpu.config import JobConfig  # noqa: E402
from fastkmer_tpu.ingest import batch as jbatch  # noqa: E402
from fastkmer_tpu.output import manifest as jman  # noqa: E402
from fastkmer_tpu.parallel import driver as jdriver  # noqa: E402
from fastkmer_tpu.parallel import exchange as jx  # noqa: E402
from fastkmer_tpu_torch import api as tapi  # noqa: E402
from fastkmer_tpu_torch import pipeline as tpipe  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as tbatch  # noqa: E402
from fastkmer_tpu_torch.output import manifest as tman  # noqa: E402
from fastkmer_tpu_torch.parallel import driver as tdriver  # noqa: E402
from fastkmer_tpu_torch.parallel import exchange as tx  # noqa: E402

from . import oracles  # noqa: E402
from .test_pipeline_e2e import result_as_dict, write_fasta  # noqa: E402
from .test_torch_cli import _dir_bytes  # noqa: E402
from .test_torch_pipeline import _assert_tables_equal, _npz_members, mixed_reads  # noqa: E402

K, M, B = 25, 8, 32
DIE_AT = 5  # the batch whose read raises: checkpoints at 2 and 4 survive


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("durable")
    reads = mixed_reads(31, n=40)
    fa = str(d / "in.fa")
    write_fasta(fa, reads)
    return d, fa, reads


def _cfg(d, fa, prefix, **kw):
    return JobConfig(dataset=fa, output_directory=str(d) + "/", prefix=prefix, k=K, m=M,
                     max_b=B, reads_per_batch=8, read_len=256, **kw)


def _jax_dir(cfg, run) -> dict:
    """Run the JAX job into cfg.output_dir; -> its bytes (the directory is
    emptied for the port's run into the same path)."""
    run()
    out = _dir_bytes(cfg.output_dir)
    shutil.rmtree(cfg.output_dir)
    return out


@pytest.fixture(scope="module")
def jax_single(data):
    """Uninterrupted JAX single-device runs: sort (the host path on the
    CPU) and HT, text output."""
    d, fa, _ = data
    return {ht: _jax_dir(c, lambda c=c: jpipe.execute_job(c, verbose=False))
            for ht in (False, True) for c in (_cfg(d, fa, f"s{int(ht)}_", use_ht=ht),)}


@pytest.fixture(scope="module")
def jax_mesh(data):
    """Uninterrupted JAX mesh runs on 4 virtual CPU devices: streaming,
    per batch with super-k-mer transport, per batch with the HT engine."""
    d, fa, _ = data
    mesh = jax.make_mesh((4,), (jx.AXIS,), devices=jax.devices("cpu")[:4])
    out = {}
    for label, kw, ht in (("stream", {}, False), ("smer", {"smer_transport": True}, False),
                          ("ht", {}, True)):
        cfg = _cfg(d, fa, f"m_{label}_", use_ht=ht)
        out[label] = _jax_dir(cfg, lambda cfg=cfg, kw=kw: jdriver.execute_job_distributed(
            cfg, mesh, verbose=False, **kw))
    return out


def _dying(batch_file, at=DIE_AT):
    """batch_file that raises KeyboardInterrupt when batch ``at`` is read."""
    def dying_batch_file(*a, **kw):
        for i, b in enumerate(batch_file(*a, **kw)):
            if i == at:
                raise KeyboardInterrupt
            yield b
    return dying_batch_file


def _interrupt_then_resume(monkeypatch, run, ck, cursor=4):
    """Run ``run(checkpoint_dir)`` with a batch reader that dies, check the
    cursor it left (the interval's last boundary, or every batch read for
    the per-batch flow), then resume with a fresh call on the same
    directory."""
    real = tbatch.batch_file
    monkeypatch.setattr(tbatch, "batch_file", _dying(real))
    with pytest.raises(KeyboardInterrupt):
        run(ck)
    monkeypatch.setattr(tbatch, "batch_file", real)
    assert tman.BatchCheckpointer(ck).completed_batches() == cursor
    res = run(ck)
    assert os.path.isdir(ck) and not os.listdir(ck)  # emptied on completion
    return res


@pytest.mark.parametrize("ht", [False, True])
def test_resume_single_device_host_path(data, jax_single, monkeypatch, tmp_path, ht):
    """The host path's per-batch flow (save_batch), sort and HT engines."""
    d, fa, reads = data
    cfg = _cfg(d, fa, f"s{int(ht)}_", use_ht=ht)
    res = _interrupt_then_resume(monkeypatch, lambda ck: tpipe.execute_job(
        cfg, verbose=False, device="cpu", checkpoint_dir=ck, checkpoint_interval=2),
        str(tmp_path / "ck"), cursor=DIE_AT)
    assert _dir_bytes(cfg.output_dir) == jax_single[ht]
    assert result_as_dict(res, K) == dict(oracles.count_reads(reads, K))
    shutil.rmtree(cfg.output_dir)


def test_resume_single_device_accumulator(data, jax_single, monkeypatch, tmp_path):
    """The accumulator's spill flow (a forced spill every interval), through
    execute_job with unique_ub, as on the card."""
    d, fa, _ = data
    cfg = _cfg(d, fa, "s0_")
    ck = str(tmp_path / "ck")
    spills = []
    real_save = tman.BatchCheckpointer.save_spills

    def spy(self, completed, parts):
        spills.append(len(parts) - self._cursor()["spills"])  # the new ones
        return real_save(self, completed, parts)

    monkeypatch.setattr(tman.BatchCheckpointer, "save_spills", spy)
    _interrupt_then_resume(monkeypatch, lambda ck: tpipe.execute_job(
        cfg, verbose=False, device="cpu", checkpoint_dir=ck, checkpoint_interval=2,
        unique_ub=1 << 16), ck)
    assert len(spills) > 2 and sum(spills) >= 2
    assert _dir_bytes(cfg.output_dir) == jax_single[False]
    shutil.rmtree(cfg.output_dir)


@pytest.mark.parametrize("label", ["stream", "smer", "ht"])
def test_resume_mesh(data, jax_mesh, monkeypatch, tmp_path, label):
    """The streaming mesh's spill flow, and the per-batch mesh's compacted
    parts re-split by owner on resume (super-k-mer transport, HT engine)."""
    d, fa, _ = data
    cfg = _cfg(d, fa, f"m_{label}_", use_ht=label == "ht")
    kw = {"smer_transport": True} if label == "smer" else {}
    mesh = tx.make_mesh(4, "cpu")
    res = _interrupt_then_resume(monkeypatch, lambda ck: tdriver.execute_job_distributed(
        cfg, mesh, verbose=False, checkpoint_dir=ck, checkpoint_interval=2, **kw),
        str(tmp_path / "ck"))
    assert _dir_bytes(cfg.output_dir) == jax_mesh[label]
    assert res.n_batches > DIE_AT
    shutil.rmtree(cfg.output_dir)


@pytest.mark.parametrize("label", ["smer", "ht"])
def test_per_batch_checkpoint_resumes_on_the_per_batch_mesh(data, jax_mesh, monkeypatch,
                                                           tmp_path, label):
    """A directory the host path checkpointed per batch, resumed twice by
    the per-batch mesh: its first checkpoint persists the loaded parts as
    spills beside its own, so the second resume still covers every batch."""
    d, fa, _ = data
    cfg = _cfg(d, fa, f"m_{label}_", use_ht=label == "ht")
    kw = {"smer_transport": True} if label == "smer" else {}
    mesh = tx.make_mesh(4, "cpu")
    ck = str(tmp_path / "ck")

    def mesh_run():
        return tdriver.execute_job_distributed(
            cfg, mesh, verbose=False, checkpoint_dir=ck, checkpoint_interval=2, **kw)

    real = tbatch.batch_file
    for run, at, cursor in (
        (lambda: tpipe.execute_job(cfg, verbose=False, device="cpu", checkpoint_dir=ck,
                                   checkpoint_interval=2), DIE_AT, DIE_AT),
        (mesh_run, DIE_AT + 2, DIE_AT + 1),
    ):
        monkeypatch.setattr(tbatch, "batch_file", _dying(real, at))
        with pytest.raises(KeyboardInterrupt):
            run()
        monkeypatch.setattr(tbatch, "batch_file", real)
        assert tman.BatchCheckpointer(ck).completed_batches() == cursor
    assert tman.BatchCheckpointer(ck)._cursor()["spills"] > DIE_AT  # the loaded parts too
    res = mesh_run()
    assert _dir_bytes(cfg.output_dir) == jax_mesh[label]
    assert res.n_batches > DIE_AT + 2 and not os.listdir(ck)
    shutil.rmtree(cfg.output_dir)


@pytest.mark.parametrize("accumulate", [False, True])
def test_jax_checkpoint_resumes_in_the_port(data, tmp_path, accumulate):
    """A checkpoint directory an interrupted JAX run left behind (per-batch
    parts, or accumulator spills) resumes in the port to the JAX table."""
    d, fa, _ = data

    def batches():
        return jbatch.batch_file(fa, 0, K, 8, 256)

    ck = str(tmp_path / "ck")
    done = list(batches())[:4]
    jpipe.count_batches(done, K, M, B, device_accumulate=accumulate,
                        checkpointer=jman.BatchCheckpointer(ck, interval=2))
    assert jman.BatchCheckpointer(ck).completed_batches() == 4
    want = jpipe.count_batches(batches(), K, M, B, device_accumulate=accumulate)
    got = tpipe.count_batches(batches(), K, M, B, device="cpu",
                              device_accumulate=accumulate,
                              checkpointer=tman.BatchCheckpointer(ck, interval=2))
    _assert_tables_equal(got, want)


def test_kryo_verify_and_repair(data, tmp_path):
    """Binary output: verify catches a flipped byte in counts.npz, and
    repair_output rebuilds it from the sidecar; its arrays are the JAX run's."""
    d, fa, _ = data
    cfg = _cfg(d, fa, "kr_", use_kryo_serializer=True)
    jpipe.execute_job(cfg, verbose=False, keep_table=True)
    want = _npz_members(open(os.path.join(cfg.output_dir, "counts.npz"), "rb").read())
    shutil.rmtree(cfg.output_dir)
    tpipe.execute_job(cfg, verbose=False, keep_table=True, device="cpu")
    assert tapi.verify_output(cfg.output_dir)["ok"]
    path = os.path.join(cfg.output_dir, "counts.npz")
    data_ = bytearray(open(path, "rb").read())
    data_[len(data_) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data_))
    v = tapi.verify_output(cfg.output_dir)
    assert not v["ok"] and "counts.npz" in v["extra_mismatched"]
    assert v == jman.verify_output(cfg.output_dir)
    status = tpipe.repair_output(cfg, verbose=False, device="cpu")
    assert status["ok"], status
    assert _npz_members(open(path, "rb").read()) == want
    got, ref = tapi.load_binary(path), japi.load_binary(path)
    for f in ("words", "counts", "bins", "n_instances"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


def test_binary_repair_guards(data, tmp_path):
    """Sharded binary outputs raise; a damaged sibling artifact alone is
    reported with no recount and counts.npz untouched."""
    d, fa, _ = data
    cfg = _cfg(tmp_path, "unused.fa", "sh_")
    os.makedirs(cfg.output_dir)
    with open(os.path.join(cfg.output_dir, "manifest.json"), "w") as f:
        json.dump({"config": {}, "n_unique": 1, "n_instances": 1, "checksum": "x",
                   "binary": True, "shards": ["a", "b"], "bins": {},
                   "extra_files": {"counts.part0.npz": "00", "counts.part1.npz": "11"}}, f)
    with pytest.raises(NotImplementedError, match="shard"):
        tpipe.repair_output(cfg, verbose=False, device="cpu")
    cfg = _cfg(tmp_path, fa, "sib_", use_kryo_serializer=True)
    res = tpipe.execute_job(cfg, verbose=False, device="cpu")
    sib = os.path.join(cfg.output_dir, "distances.json")
    open(sib, "w").write("{}")
    tpipe.writer.write_binary_with_manifest(
        cfg.output_dir, tpipe.dataclasses_dict(cfg), res.words, res.counts, res.bins, K,
        extra_files={"distances.json": tman.file_sha256(sib)})
    open(sib, "a").write(" ")
    npz = os.path.join(cfg.output_dir, "counts.npz")
    before = open(npz, "rb").read()
    status = tpipe.repair_output(cfg, verbose=False, device="cpu")
    assert not status["ok"] and status["extra_mismatched"] == ["distances.json"]
    assert open(npz, "rb").read() == before


def test_rerun_cleans_stale_outputs(data, tmp_path):
    d, fa, _ = data
    text = _cfg(tmp_path, fa, "sw_")
    kryo = _cfg(tmp_path, fa, "sw_", use_kryo_serializer=True)
    out = text.output_dir
    tpipe.execute_job(text, verbose=False, device="cpu")
    assert [f for f in os.listdir(out) if f.startswith("bin")]
    tpipe.execute_job(kryo, verbose=False, device="cpu")
    assert not [f for f in os.listdir(out) if f.startswith("bin")]
    assert os.path.exists(os.path.join(out, "counts.npz")) and tapi.verify_output(out)["ok"]
    tpipe.execute_job(text, verbose=False, device="cpu")
    assert not os.path.exists(os.path.join(out, "counts.npz"))
    assert tapi.verify_output(out)["ok"]


def test_checkpoint_rollback(tmp_path):
    ckpt = tman.BatchCheckpointer(str(tmp_path), interval=2)
    part = [(np.ones((1, 2), np.uint32), np.ones(1, np.int64), np.zeros(1, np.int32))]
    ckpt.save_spills(2, part)
    ckpt.save_spills(4, part * 2)  # every part the run holds: one new
    assert ckpt.completed_batches() == 4 and len(ckpt.load_parts()) == 2
    assert ckpt.rollback_to(10) == 4  # past the cursor: a no-op
    assert ckpt.rollback_to(2) == 2
    assert ckpt.completed_batches() == 2 and len(ckpt.load_parts()) == 1
    assert not (tmp_path / "spill000001.npz").exists()
    assert ckpt.rollback_to(1) == 0  # below every entry: the zero state
    assert ckpt.load_parts() == [] and not (tmp_path / "spill000000.npz").exists()


def test_per_batch_checkpoint_resumes_in_the_accumulator(tmp_path):
    """A directory the host path checkpointed per batch, resumed by the
    accumulator (a run moved to the card): its first spill checkpoint
    persists the loaded parts with the new spills, so a second resume
    still covers every batch."""
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 4, (16, 256), dtype=np.uint8), 16, 16 * 256)
               for _ in range(10)]

    class Stop(Exception):
        pass

    def until(n):
        for i, b in enumerate(batches):
            if i == n:
                raise Stop
            yield b

    ckpt = tman.BatchCheckpointer(str(tmp_path), interval=2)
    for n, accumulate in ((4, False), (7, True)):
        with pytest.raises(Stop):
            tpipe.count_batches(until(n), K, M, B, device="cpu",
                                device_accumulate=accumulate, checkpointer=ckpt)
    assert ckpt.completed_batches() == 6 and ckpt._cursor()["spills"] == 5
    got = tpipe.count_batches(batches, K, M, B, device="cpu", device_accumulate=True,
                              checkpointer=ckpt)
    want = tpipe.count_batches(batches, K, M, B, device="cpu", device_accumulate=False)
    _assert_tables_equal(got, want)


def _bins(out: str) -> dict[str, bytes]:
    return {n: b for n, b in _dir_bytes(out).items() if n.startswith("bin")}


@pytest.mark.parametrize("ht", [False, True])
def test_repair_output(data, jax_single, tmp_path, ht):
    """A deleted bin is restored by a recount, byte for byte (no EOF line
    under HT)."""
    d, fa, _ = data
    cfg = _cfg(tmp_path, fa, "rp_", use_ht=ht)
    tpipe.execute_job(cfg, verbose=False, device="cpu")
    before = _dir_bytes(cfg.output_dir)
    victim = sorted(_bins(cfg.output_dir))[1]
    os.remove(os.path.join(cfg.output_dir, victim))
    status = tpipe.repair_output(cfg, verbose=False, device="cpu")
    assert status["ok"], status
    assert _dir_bytes(cfg.output_dir) == before
    assert _bins(cfg.output_dir) == {n: b for n, b in jax_single[ht].items()
                                     if n.startswith("bin")}


def test_repair_from_sidecar_no_recount(data, tmp_path, monkeypatch):
    d, fa, _ = data
    cfg = _cfg(tmp_path, fa, "sc_")
    tpipe.execute_job(cfg, verbose=False, keep_table=True, device="cpu")
    before = _dir_bytes(cfg.output_dir)
    os.remove(os.path.join(cfg.output_dir, sorted(_bins(cfg.output_dir))[0]))

    def no_recount(*a, **kw):
        raise AssertionError("repair recounted the dataset despite the sidecar")

    monkeypatch.setattr(tpipe, "count_batches", no_recount)
    assert tpipe.repair_output(cfg, verbose=False, device="cpu")["ok"]
    assert _dir_bytes(cfg.output_dir) == before
    sidecar = os.path.join(cfg.output_dir, tman.TABLE_SIDECAR)
    with np.load(sidecar) as z:
        words, counts, bins = z["words"], z["counts"], z["bins"]
    with open(sidecar, "wb") as f:
        np.savez(f, words=words, counts=counts + 1, bins=bins)
    assert tman.load_table_sidecar(cfg.output_dir) is None


def test_verify_detects_content_corruption(data, tmp_path):
    """A flipped count digit at the same line count fails verification in
    both packages' verify_output, and repair restores the bytes."""
    d, fa, _ = data
    cfg = _cfg(tmp_path, fa, "cc_")
    tpipe.execute_job(cfg, verbose=False, keep_table=True, device="cpu")
    before = _dir_bytes(cfg.output_dir)
    victim = sorted(_bins(cfg.output_dir))[0]
    buf = bytearray(before[victim])
    pos = buf.index(b"\t") + 1
    buf[pos] = ord("1") if buf[pos] != ord("1") else ord("2")
    open(os.path.join(cfg.output_dir, victim), "wb").write(bytes(buf))
    v = tapi.verify_output(cfg.output_dir)
    assert not v["ok"] and int(victim[3:]) in v["mismatched"]
    assert v == jman.verify_output(cfg.output_dir)
    assert tpipe.repair_output(cfg, verbose=False, device="cpu")["ok"]
    assert _dir_bytes(cfg.output_dir) == before


@pytest.mark.parametrize("kryo", [False, True])
def test_repair_recounts_with_the_manifest_config(data, tmp_path, kryo):
    """A caller config that names another dataset: the recount reads the
    dataset the manifest records, so the repaired output is the original
    (the JAX binary repair would recount the caller's dataset)."""
    d, fa, _ = data
    cfg = _cfg(tmp_path, fa, "mc_", use_kryo_serializer=kryo)
    tpipe.execute_job(cfg, verbose=False, device="cpu")
    before = _dir_bytes(cfg.output_dir)
    other = str(tmp_path / "other.fa")
    write_fasta(other, mixed_reads(99, n=5))
    victim = "counts.npz" if kryo else sorted(_bins(cfg.output_dir))[0]
    os.remove(os.path.join(cfg.output_dir, victim))
    status = tpipe.repair_output(_cfg(tmp_path, other, "mc_", use_kryo_serializer=kryo),
                                 verbose=False, device="cpu")
    assert status["ok"], status
    after = _dir_bytes(cfg.output_dir)
    if kryo:
        assert _npz_members(after.pop("counts.npz")) == _npz_members(before.pop("counts.npz"))
        assert (json.loads(after.pop("manifest.json"))["checksum"]
                == json.loads(before.pop("manifest.json"))["checksum"])
    assert after == before
