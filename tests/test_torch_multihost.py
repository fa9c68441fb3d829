"""Multi-process meshes of fastkmer_tpu_torch (``parallel.multihost`` on
``torch.distributed`` with gloo) vs fastkmer_tpu on a single-process JAX
mesh of the same global width.

Two groups of worker processes run at once, 2 ranks and 3 ranks, each
rank with 2 CPU shards (global meshes of 4 and 6); meanwhile the parent
runs each JAX counterpart once on 4 and 6 of the 8 virtual CPU devices.
Each rank feeds its stripe of every global batch and saves its own table;
the parent checks that the ranks' tables are disjoint and that their union
is JAX's table, through the raw and adaptive-dedup transports, an uneven
tail, window retries and spills.  Every host decision reads a value
reduced over the ranks: the cases make the ranks' local values differ (a
dedup ratio on either side of the threshold, drops and a full shard on one
rank only, a fingerprint collision on one rank, resume cursors one
interval apart) and check that every rank took the same branch.  The
driver writes into one shared directory: bin files, the ranks' manifest
shards and the merged manifest byte-identical to the JAX package's files
for JAX's table split by the owner map into the same ranks.  Integer
outputs, so the tolerance is bit-equality.

A rank's process group raises after 30 s of waiting in a collective, and
each worker is killed at its ``communicate`` timeout, so a desync fails
the module instead of hanging it.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from fastkmer_tpu import pipeline as jpipeline  # noqa: E402
from fastkmer_tpu.config import JobConfig as JJobConfig  # noqa: E402
from fastkmer_tpu.output import manifest as jman  # noqa: E402
from fastkmer_tpu.output import writer as jwriter  # noqa: E402
from fastkmer_tpu.parallel import driver as jdriver  # noqa: E402
from fastkmer_tpu.parallel import exchange as jx  # noqa: E402
from fastkmer_tpu.parallel import partitioner as jpart  # noqa: E402
from fastkmer_tpu.parallel import stream as jstream  # noqa: E402
from fastkmer_tpu_torch import pipeline as tpipeline  # noqa: E402
from fastkmer_tpu_torch.output import manifest as tman  # noqa: E402

from .test_pipeline_e2e import write_fasta  # noqa: E402
from .test_torch_cli import _dir_bytes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, M, B, L = 25, 8, 64, 96
N_LOCAL = 2  # shards on each rank
ROWS = {2: 16, 3: 18}  # the driver's global batch rows: a multiple of shards x ranks
WORKER_TIMEOUT_S = 400

_WORKER = r'''
import json, os, sys
rank, world, port, out, repo = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                sys.argv[5])
sys.path.insert(0, repo)
import numpy as np
from fastkmer_tpu_torch.config import JobConfig
from fastkmer_tpu_torch.ops import count_hash
from fastkmer_tpu_torch.output import manifest
from fastkmer_tpu_torch.parallel import driver, multihost, partitioner, stream

K, M, B, L = 25, 8, 64, 96
ROWS = {2: 16, 3: 18}[world]  # global batch rows: a multiple of shards x ranks
if world == 2:  # the launcher's environment, as torchrun sets it
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    multihost.init_distributed(device="cpu", timeout_s=30)
else:
    multihost.init_distributed("localhost:" + port, world, rank, device="cpu", timeout_s=30)
mesh = multihost.init_global_mesh(2, "cpu")
assert (mesh.size, mesh.rank, mesh.world, mesh.comm.backend) == (2 * world, rank, world, "gloo")
n = mesh.size
res = {}


def save(name, table, **extra):
    words, counts, bins = table
    np.savez(f"{out}/{name}.r{rank}.npz", words=words, counts=counts, bins=bins)
    res[name] = extra


def feed_all(ctr, batches):
    """Feed this rank's stripe of each global batch."""
    for g in batches:
        r = g.shape[0] // world
        ctr.feed(np.ascontiguousarray(g[rank * r : (rank + 1) * r]), n_reads=r)
    return ctr.finalize()


def counter(name, batches, owner, spills=None, **kw):
    ctr = stream.DistributedCounter(mesh, K, M, B, owner_map=owner, **kw)
    ctr.PROBE_EVERY, ctr.PROBE_LAG = 2, 1
    if spills is not None:
        orig = ctr._spill
        ctr._spill = lambda stats: (spills.append(1), orig(stats))
    table = feed_all(ctr, batches)
    save(name, table, exchange_bytes=ctr.exchange_bytes, n_dedup=ctr.n_dedup_batches,
         n_retries=ctr.n_retries, cap=ctr.cap, cap_d=ctr.cap_d, dedup_mode=ctr._dedup_mode,
         n_spills=0 if spills is None else len(spills))


def cfg(prefix, **kw):
    base = dict(dataset=out + "/reads.fa", output_directory=out + "/", prefix=prefix, k=K, m=M,
                x=3, max_b=B, sequence_type=0, write=True, reads_per_batch=ROWS, read_len=L)
    base.update(kw)
    return JobConfig(**base)


def job(name, c, **kw):
    r = driver.execute_job_distributed(c, mesh, verbose=False, **kw)
    save(name, (r.words, r.counts, r.bins), exchange_bytes=r.exchange_bytes,
         n_dedup=r.n_dedup_batches, n_batches=r.n_batches, owner_map=r.owner_map.tolist(),
         cross_rank=r.timings.get("cross_rank", 0.0), n_reads=r.n_reads)


def raises(fn, exc):
    try:
        fn()
    except exc as e:
        return type(e).__name__
    return None


def dying_stripes(at):
    """stripe_batches_padded whose main-loop call (its second: the first
    sizes the cap) raises when the rank's step ``at`` is asked for, on
    every rank alike."""
    orig, calls = multihost.stripe_batches_padded, []

    def stripes(*a, **kw):
        calls.append(1)
        for i, b in enumerate(orig(*a, **kw)):
            if len(calls) == 2 and i == at:
                raise KeyboardInterrupt("killed")
            yield b
    return orig, stripes


def resume(name, **kw):
    """Die after step 3 (a checkpoint a step), roll rank 0 back to
    cursor 2 as if its last cursor write was lost, then run again."""
    ck = f"{out}/ck_{name}{rank}"
    orig, stripes = dying_stripes(3)
    multihost.stripe_batches_padded = stripes
    try:
        died = raises(lambda: driver.execute_job_distributed(
            cfg("rs_", write=False), mesh, verbose=False, checkpoint_dir=ck,
            checkpoint_interval=1, **kw), KeyboardInterrupt)
    finally:
        multihost.stripe_batches_padded = orig
    ckpt = manifest.BatchCheckpointer(ck)
    before = ckpt.completed_batches()
    if rank == 0:
        ckpt.rollback_to(2)
    r = driver.execute_job_distributed(cfg("rs_", write=False), mesh, verbose=False,
                                       checkpoint_dir=ck, checkpoint_interval=1, **kw)
    save(name, (r.words, r.counts, r.bins), died=died, cursor_before=before,
         cleared=not os.listdir(ck))


if world == 2:
    counter("raw", np.load(out + "/raw.npy"), partitioner.hash_owner_map(B, n), cap=2048,
            acc_cap=1 << 14, fanin=2)
    skew = np.load(out + "/skew.npy")
    half = skew[0][rank * 32 : (rank + 1) * 32]  # this rank's stripe of a batch
    ratio = sum(len(np.unique(s, axis=0)) for s in (half[:16], half[16:])) / 32
    counter("dedup", skew, partitioner.hash_owner_map(B, n), cap=2048, acc_cap=1 << 14,
            fanin=2, prededup=None)
    res["dedup"]["local_ratio"] = ratio
    counter("retry", np.load(out + "/retry.npy"), partitioner.hash_owner_map(B, n), cap=8,
            acc_cap=1 << 14, fanin=2)
    counter("spill", np.load(out + "/spill.npy"), np.load(out + "/spill_owner.npy"), spills=[],
            cap=512, acc_cap=2048, fanin=1)
    # HT: a fingerprint collision found on rank 0 only raises on every rank
    orig = count_hash.count_hashed
    if rank == 0:
        count_hash.count_hashed = lambda *a, **kw: (lambda sc, c: (sc, c + 1))(*orig(*a, **kw))
    res["collision"] = raises(lambda: driver.execute_job_distributed(
        cfg("ht_", use_ht=True, write=False), mesh, verbose=False),
        count_hash.FingerprintCollision)
    count_hash.count_hashed = orig
    job("stream", cfg("mh_", use_custom_partitioner=True, num_partition_tasks=4))
    job("smer", cfg("mhs_"), smer_transport=True)
    resume("resume_stream")
    resume("resume_smer", smer_transport=True)
    res["keep_table"] = raises(lambda: driver.execute_job_distributed(
        cfg("kt_"), mesh, verbose=False, keep_table=True), NotImplementedError)
    from fastkmer_tpu_torch.multiseq.distributed import execute_multiseq_job_distributed
    from fastkmer_tpu_torch.multiseq.pipeline import MultiseqConfig
    res["multiseq"] = raises(lambda: execute_multiseq_job_distributed(
        MultiseqConfig(dataset=out + "/reads.fa", output_directory=out + "/", prefix="ms_", k=K,
                       m=M, max_b=B), mesh, verbose=False), NotImplementedError)
else:
    # three distinct resume cursors agree on the minimum and roll back to it
    ck = manifest.BatchCheckpointer(f"{out}/ck{rank}", interval=2)
    part = [(np.ones((1, 2), np.uint32), np.ones(1, np.int64), np.zeros(1, np.int32))]
    for c in range(2, 2 * (rank + 1) + 1, 2):  # rank r logged cursors 2, ..., 2(r + 1)
        ck.save_spills(c, part, c // 2 - 1)
    own = ck.completed_batches()
    agreed = multihost.agree_min(own, mesh.comm)
    res["agree"] = dict(own=own, agreed=agreed, resumed=ck.rollback_to(agreed),
                        parts=len(ck.load_parts()))
    counter("tail", np.load(out + "/tail.npy"), partitioner.hash_owner_map(B, n), cap=2048,
            acc_cap=1 << 14, fanin=2)
    counter("dedup", np.load(out + "/dup3.npy"), partitioner.hash_owner_map(B, n), cap=2048,
            acc_cap=1 << 14, fanin=2, prededup=None)
    job("stream", cfg("mh3_", use_custom_partitioner=True, num_partition_tasks=6))
    job("smer", cfg("mh3s_"), smer_transport=True)
    job("kryo", cfg("mh3k_", use_kryo_serializer=True), smer_transport=True,
        checkpoint_dir=f"{out}/ckpb{rank}", checkpoint_interval=1)
    res["kryo"]["cleared"] = not os.listdir(f"{out}/ckpb{rank}")
with open(f"{out}/res.r{rank}.json", "w") as f:
    json.dump(res, f)
print("WORKER_OK", rank, flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rand(rng, shape) -> np.ndarray:
    return rng.integers(0, 4, size=shape).astype(np.uint8)


def _write_inputs(d: str) -> dict:
    """The global batches of every counter case, the FASTA of the driver
    cases and the spill case's owner map (bins 0-59 on shard 0)."""
    rng = np.random.default_rng(7)
    raw = _rand(rng, (4, 8, L))
    # dedup: rank 0's rows are copies of one read (local distinct ratio
    # 1/16), rank 1's a third random (7/16, above ENGAGE_BELOW); the global
    # ratio is 1/4: every rank must engage
    skew = np.empty((6, 64, L), np.uint8)
    for g in range(6):
        a, b = _rand(rng, (1, L)), _rand(rng, (1, L))
        skew[g, :32] = a
        for s in (32, 48):
            skew[g, s : s + 6] = _rand(rng, (6, L))
            skew[g, s + 6 : s + 16] = b
    # retry: rank 0's rows are random, rank 1's all invalid: only rank 0
    # drops at cap 8
    retry = np.full((4, 16, L), 4, np.uint8)
    retry[:, :8] = _rand(rng, (4, 8, L))
    spill = _rand(rng, (6, 16, L))
    owner = np.zeros(B, np.int32)
    owner[60:] = [1, 2, 3, 3]
    # 26 reads over 3 ranks of 4 rows: the last global batch is partial
    tail = np.full((3, 12, L), 4, np.uint8)
    tail.reshape(36, L)[:26] = _rand(rng, (26, L))
    dup3 = np.tile(_rand(rng, (1, L)), (6, 24, 1))
    reads = ["".join("ACGT"[c] for c in row) for row in _rand(rng, (96, L))]
    for i in range(0, 96, 7):  # some Ns and some copies
        reads[i] = reads[i][:30] + "N" + reads[i][31:]
        reads[i + 1] = reads[i - 6] if i >= 6 else reads[i + 1]
    for name, a in (("raw", raw), ("skew", skew), ("retry", retry), ("spill", spill),
                    ("spill_owner", owner), ("tail", tail), ("dup3", dup3)):
        np.save(os.path.join(d, f"{name}.npy"), a)
    write_fasta(os.path.join(d, "reads.fa"), reads)
    return dict(raw=raw, skew=skew, retry=retry, spill=spill, owner=owner, tail=tail, dup3=dup3)


def _jax_counter(mesh, batches, owner, **kw):
    ctr = jstream.DistributedCounter(mesh, K, M, B, owner_map=owner, **kw)
    ctr.PROBE_EVERY, ctr.PROBE_LAG = 2, 1
    for g in batches:
        ctr.feed(np.ascontiguousarray(g), n_reads=g.shape[0])
    return ctr, ctr.finalize()


def _jax_job(mesh, fa, out, world):
    cfg = JJobConfig(dataset=fa, output_directory=out + "/", prefix="j_", k=K, m=M, x=3,
                     max_b=B, sequence_type=0, write=True, reads_per_batch=ROWS[world],
                     read_len=L, use_custom_partitioner=True, num_partition_tasks=2 * world)
    return jdriver.execute_job_distributed(cfg, mesh, verbose=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both worker groups, run the JAX counterparts meanwhile, then
    collect the ranks' results."""
    groups = {}
    data = {}
    # one thread a rank: the shapes are tiny, and five ranks share the CPU
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for world in (2, 3):
        d = str(tmp_path_factory.mktemp(f"p{world}"))
        data[world] = _write_inputs(d)
        script = os.path.join(d, "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        port = str(_free_port())
        groups[world] = (d, [
            subprocess.Popen([sys.executable, script, str(r), str(world), port, d, REPO],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for r in range(world)])
    jax_runs = {}
    try:
        for world, n in ((2, 4), (3, 6)):
            mesh = jax.make_mesh((n,), (jx.AXIS,), devices=jax.devices("cpu")[:n])
            dd = data[world]
            hash_owner = jpart.hash_owner_map(B, n)
            jr = jax_runs[world] = {}
            if world == 2:
                jr["raw"] = _jax_counter(mesh, dd["raw"], hash_owner, cap=2048, acc_cap=1 << 14,
                                         fanin=2)
                jr["dedup"] = _jax_counter(mesh, dd["skew"], hash_owner, cap=2048,
                                           acc_cap=1 << 14, fanin=2, prededup=None)
                jr["retry"] = _jax_counter(mesh, dd["retry"], hash_owner, cap=8,
                                           acc_cap=1 << 14, fanin=2)
                jr["spill"] = _jax_counter(mesh, dd["spill"], dd["owner"], cap=512,
                                           acc_cap=2048, fanin=1)
            else:
                jr["tail"] = _jax_counter(mesh, dd["tail"], hash_owner, cap=2048,
                                          acc_cap=1 << 14, fanin=2)
                jr["dedup"] = _jax_counter(mesh, dd["dup3"], hash_owner, cap=2048,
                                           acc_cap=1 << 14, fanin=2, prededup=None)
            jd = str(tmp_path_factory.mktemp(f"jax{world}"))
            jr["job"] = _jax_job(mesh, os.path.join(groups[world][0], "reads.fa"), jd, world)
            jr["job_dir"] = os.path.join(jd, f"j_k{K}_m{M}_x3_b{B}_s0")
    finally:
        outs = {}
        for world, (d, procs) in groups.items():
            for r, p in enumerate(procs):
                try:
                    outs[(world, r)] = p.communicate(timeout=WORKER_TIMEOUT_S)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs[(world, r)] = p.communicate()[0] + "\n[killed at the timeout]"
    for (world, r), out in outs.items():
        assert f"WORKER_OK {r}" in out, f"p={world} rank {r} failed:\n{out[-3000:]}"
    res = {}
    for world, (d, _) in groups.items():
        res[world] = [json.load(open(os.path.join(d, f"res.r{r}.json"))) for r in range(world)]
    return {w: dict(dir=groups[w][0], res=res[w], jax=jax_runs[w], data=data[w]) for w in groups}


def _union(run, name: str):
    """The ranks' tables of one case: disjoint, and their union in k-mer
    order."""
    parts = [np.load(os.path.join(run["dir"], f"{name}.r{r}.npz")) for r in range(len(run["res"]))]
    words = np.concatenate([p["words"] for p in parts])
    counts = np.concatenate([p["counts"] for p in parts])
    bins = np.concatenate([p["bins"] for p in parts])
    assert len({w.tobytes() for w in words}) == words.shape[0], f"{name}: ranks share a k-mer"
    order = np.lexsort(tuple(words[:, w] for w in reversed(range(words.shape[1]))))
    return words[order], counts[order], bins[order]


def _same_table(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _same_on_every_rank(run, name, *fields):
    for f in fields:
        vals = [r[name][f] for r in run["res"]]
        assert all(v == vals[0] for v in vals), (name, f, vals)
    return run["res"][0][name]


@pytest.mark.parametrize("world,name", [(2, "raw"), (3, "tail")])
def test_streaming_tables_match_jax(runs, world, name):
    """Raw transport (p = 2), and 26 reads over 3 ranks whose last global
    batch is partial and padded (p = 3): disjoint tables whose union is
    JAX's table, with JAX's exchange bytes, caps and merge count."""
    run = runs[world]
    jctr, want = run["jax"][name]
    _same_table(_union(run, name), want)
    r0 = _same_on_every_rank(run, name, "exchange_bytes", "cap", "n_dedup")
    assert (r0["exchange_bytes"], r0["cap"], r0["n_dedup"]) == (
        jctr.exchange_bytes, jctr.cap, jctr.n_dedup_batches)


@pytest.mark.parametrize("world", [2, 3])
def test_adaptive_dedup_flips_in_lockstep(runs, world):
    """The probe ratio is summed over the ranks: at p = 2 rank 0's local
    ratio is under the engage threshold and rank 1's above it, yet both
    engage at the same batch, as JAX's single-process counter does; the
    dedup batch count, cap_d and the table equal JAX's on every rank."""
    run = runs[world]
    jctr, want = run["jax"]["dedup"]
    r0 = _same_on_every_rank(run, "dedup", "n_dedup", "cap_d", "dedup_mode", "exchange_bytes")
    assert r0["n_dedup"] == jctr.n_dedup_batches and r0["n_dedup"] >= 4
    assert (r0["cap_d"], r0["exchange_bytes"]) == (jctr.cap_d, jctr.exchange_bytes)
    if world == 2:
        ratios = [r["dedup"]["local_ratio"] for r in run["res"]]
        assert ratios[0] < jstream.DistributedCounter.ENGAGE_BELOW < ratios[1], ratios
    _same_table(_union(run, "dedup"), want)


def test_window_retry_in_lockstep(runs):
    """Only rank 0's shards drop rows at cap 8; the drops are summed over
    the ranks, so both replay the same windows at the same doubled caps as
    JAX's counter, and the table is exact."""
    run = runs[2]
    jctr, want = run["jax"]["retry"]
    r0 = _same_on_every_rank(run, "retry", "n_retries", "cap", "exchange_bytes")
    assert r0["n_retries"] == jctr.n_retries > 0
    assert (r0["cap"], r0["exchange_bytes"]) == (jctr.cap, jctr.exchange_bytes)
    _same_table(_union(run, "retry"), want)


def test_spill_in_lockstep(runs):
    """The owner map puts bins 0-59 on shard 0 (rank 0): rank 1's shards
    alone would never fill, yet every rank spills at the same merges (the
    occupancy is the fullest shard of any rank), and the table is JAX's."""
    run = runs[2]
    r0 = _same_on_every_rank(run, "spill", "n_spills")
    assert r0["n_spills"] >= 2
    _same_table(_union(run, "spill"), run["jax"]["spill"][1])


def test_collision_on_one_rank_raises_on_every_rank(runs):
    assert [r["collision"] for r in runs[2]["res"]] == ["FingerprintCollision"] * 2


def test_agree_min_rolls_back_three_cursors(runs):
    """Ranks that logged cursors up to 2, 4 and 6 agree on 2 and each
    rolls back to it, keeping one spill."""
    got = [r["agree"] for r in runs[3]["res"]]
    assert [g["own"] for g in got] == [2, 4, 6]
    assert all(g == dict(own=g["own"], agreed=2, resumed=2, parts=1) for g in got)


def _jax_split_dir(run, world, prefix, owner_map, out):
    """What JAX's writer and manifest shards make of JAX's table split by
    ``owner_map`` into ``world`` ranks of N_LOCAL shards, under the port's
    run config (same output directory)."""
    words, counts, bins = run["jax"]["job"][:3]
    lpt = prefix in ("mh_", "mh3_")  # the streaming runs place bins by LPT
    cfg = JJobConfig(dataset=os.path.join(run["dir"], "reads.fa"),
                     output_directory=run["dir"] + "/", prefix=prefix, k=K, m=M, x=3, max_b=B,
                     sequence_type=0, write=True, reads_per_batch=ROWS[world], read_len=L,
                     use_custom_partitioner=lpt, num_partition_tasks=2 * world if lpt else 0)
    rank_of = np.asarray(owner_map)[bins] // N_LOCAL
    for r in range(world):
        sel = rank_of == r
        hashes = jwriter.write_bin_files(out, words[sel], counts[sel], bins[sel], K, clean=False)
        jman.write_manifest_shard(out, jpipeline.dataclasses_dict(cfg), words[sel], counts[sel],
                                  bins[sel], r, bin_hashes=hashes)
    jman.merge_manifest_shards(out, world)
    return _dir_bytes(out)


@pytest.mark.parametrize("world,name,prefix", [(2, "stream", "mh_"), (2, "smer", "mhs_"),
                                               (3, "stream", "mh3_"), (3, "smer", "mh3s_")])
def test_shared_directory_matches_jax(runs, tmp_path, world, name, prefix):
    """The driver over p ranks, streaming with LPT placement (the
    pre-pass histogram summed over the ranks) and per batch with
    super-k-mer transport: each rank writes its own bins into one shared
    directory.  The union of bin files is byte-identical to JAX's
    single-process output; every ``manifest.part<r>.json`` and the merged
    ``manifest.json`` are byte-identical to JAX's shard writer and merge on
    JAX's table split by the owner map; ``verify_output`` passes."""
    run = runs[world]
    jres = run["jax"]["job"]
    r0 = _same_on_every_rank(run, name, "exchange_bytes", "n_batches", "owner_map")
    if name == "stream":
        assert r0["owner_map"] == jres.owner_map.tolist()
        assert r0["exchange_bytes"] == jres.exchange_bytes
    else:
        assert r0["owner_map"] == jpart.hash_owner_map(B, 2 * world).tolist()
    got_dir = os.path.join(run["dir"], f"{prefix}k{K}_m{M}_x3_b{B}_s0")
    assert tman.verify_output(got_dir)["ok"]
    got = _dir_bytes(got_dir)
    want_bins = {n: b for n, b in _dir_bytes(run["jax"]["job_dir"]).items() if n.startswith("bin")}
    assert {n: b for n, b in got.items() if n.startswith("bin")} == want_bins
    want = _jax_split_dir(run, world, prefix, r0["owner_map"], str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    for n in sorted(want):
        assert got[n] == want[n], n
    _same_table(_union(run, name), jres[:3])
    assert sum(r[name]["n_reads"] for r in run["res"]) == jres.n_reads


@pytest.mark.parametrize("name", ["resume_stream", "resume_smer"])
def test_resume_rolls_back_to_the_fleet_minimum(runs, name):
    """Both ranks die at batch 3 with a checkpoint a batch; rank 0's cursor
    is rolled back to 2 as if its last write was lost.  The rerun agrees on
    cursor 2, rank 1 rolls back to it, and the union of the tables is
    exact; the checkpoint directories are emptied."""
    run = runs[2]
    got = [r[name] for r in run["res"]]
    assert [g["died"] for g in got] == ["KeyboardInterrupt"] * 2
    assert [g["cursor_before"] for g in got] == [3, 3]
    assert all(g["cleared"] for g in got)
    _same_table(_union(run, name), run["jax"]["job"][:3])


def test_smer_kryo_with_rank_checkpoints(runs):
    """The per-batch path with super-k-mer transport, enableKryo and a
    checkpoint directory per rank (a checkpoint a batch) at p = 3: the
    union of ``counts.part<r>.npz`` is exact and disjoint, the merged
    manifest verifies every shard, no bin file is written and the
    checkpoint directories are emptied."""
    run = runs[3]
    kdir = os.path.join(run["dir"], f"mh3k_k{K}_m{M}_x3_b{B}_s0")
    assert not [f for f in os.listdir(kdir) if f.startswith("bin")]
    parts = [np.load(os.path.join(kdir, f"counts.part{r}.npz")) for r in range(3)]
    assert all(int(p["k"]) == K for p in parts)
    words = np.concatenate([p["words"] for p in parts])
    assert len({w.tobytes() for w in words}) == words.shape[0]
    _same_table(_union(run, "kryo"), run["jax"]["job"][:3])
    assert tman.verify_output(kdir)["ok"]
    assert all(r["kryo"]["cleared"] for r in run["res"])


def test_errors_for_several_ranks(runs, tmp_path):
    """The reference's errors past one process: ``keep_table`` and
    multiseq raise on every rank; a damaged sharded binary output is not
    repaired by one process."""
    for r in runs[2]["res"]:
        assert (r["keep_table"], r["multiseq"]) == ("NotImplementedError",) * 2
    run = runs[3]
    kdir = shutil.copytree(os.path.join(run["dir"], f"mh3k_k{K}_m{M}_x3_b{B}_s0"),
                           str(tmp_path / f"mh3k_k{K}_m{M}_x3_b{B}_s0"))
    with open(os.path.join(kdir, "counts.part1.npz"), "r+b") as f:
        f.write(b"\0\0\0\0")
    assert not tman.verify_output(kdir)["ok"]
    with open(os.path.join(kdir, "manifest.json")) as f:
        cfg = tpipeline.config_from_manifest(json.load(f)["config"])
    cfg = dataclasses.replace(cfg, output_directory=str(tmp_path) + "/")
    with pytest.raises(NotImplementedError, match="sharded binary"):
        tpipeline.repair_output(cfg, verbose=False, device="cpu")


def test_cross_rank_time_is_reported(runs):
    """Each rank's driver result carries its seconds in collectives."""
    for world in (2, 3):
        assert all(r["stream"]["cross_rank"] > 0 for r in runs[world]["res"])


def test_backend_rule_is_stated_not_a_fallback(monkeypatch):
    """NCCL with a card a rank, gloo for ranks that share a card or run on
    the CPU; an explicit NCCL that cannot work raises before any group
    exists, and a CUDA run without CUDA raises instead of running on the
    CPU (the default device of ``init_global_mesh`` is the card)."""
    import torch

    from fastkmer_tpu_torch.parallel import multihost

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert multihost.choose_backend(cuda, 2, 2) == multihost.choose_backend(cuda, 1, 8) == "nccl"
    assert multihost.choose_backend(cuda, 2, 1) == "gloo"
    assert multihost.choose_backend(cpu, 1, 0) == multihost.choose_backend(cpu, 4, 8) == "gloo"
    port = f"localhost:{_free_port()}"
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        multihost.init_distributed(port, 2, 0, backend="nccl", device="cpu")
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    multihost.init_distributed(device="cpu")  # no launcher: one process
    assert multihost.world_size() == 1 and not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            multihost.init_distributed(port, 2, 0)
        with pytest.raises(RuntimeError, match="is_available"):
            multihost.init_global_mesh()
    mesh = multihost.init_global_mesh(3, "cpu")
    assert (mesh.size, mesh.n_local, mesh.world, mesh.comm) == (3, 3, 1, None)
