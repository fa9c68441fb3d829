"""Command-line driver — the port of ``fastkmer_tpu.cli``.

Accepts the reference's 13 positional arguments in the same order:

    k m x B useHT sequenceType input output prefix write enableKryo
    useCustomPartitioner [numPartitionTasks]

``--device {cuda,cpu}`` takes the place of ``--platform``.  ``--mesh N``
(N > 1) runs the mesh job over N shards (on CUDA, shard i on
``cuda:{i % device_count()}``): the streaming counter, or with
``--smer-transport`` the per-batch job with super-k-mer transport;
``useCustomPartitioner=1`` places bins by the sampled LPT pre-pass there.
``--prededup`` sets the streaming counter's dedup transport, or the single
device's pre-dedup.  useHT=1 selects the HT engine (the per-batch path on
a mesh).  ``--checkpoint-dir`` makes a run resumable, ``--keep-table``
keeps the table beside the output for a repair without recount, and
``--trace-dir`` wraps the run in a torch.profiler trace.  ``--multiseq``
switches to multisequence counting with pairwise distances under
``--distance-measure`` (multiseq.pipeline on one device, multiseq.distributed
on the streaming mesh), with the same positionals.  A flag that has no
effect on the selected path raises, as in the JAX CLI.

Under a launcher's environment (torchrun, or ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) a ``--mesh N`` run joins its process
group (``parallel.multihost``): N is then the global shard count, N/p on
each rank's card, every rank writes its own bins into the shared output
directory, and its ``--stats-json``, ``--checkpoint-dir`` and
``--trace-dir`` get its rank (``<path>.rank<r>``, ``<dir>/rank<r>``).

    python -m fastkmer_tpu_torch.cli 28 10 3 512 0 0 in.fa out/ run_ 1 0 0
    python -m fastkmer_tpu_torch.cli 28 10 3 512 0 0 in.fa out/ run_ 1 0 1 4 --mesh 4
    python -m fastkmer_tpu_torch.cli 28 10 3 512 0 0 in.fa out/ run_ 1 0 0 --multiseq
    torchrun --nproc-per-node 2 -m fastkmer_tpu_torch.cli 28 10 3 512 0 0 in.fa out/ run_ \
        1 0 1 4 --mesh 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .config import JobConfig
from .pipeline import execute_job
from .utils.timing import maybe_profile

DEFAULT_MEASURE = "multisequence.SquaredEuclidean"  # --distance-measure
# the summary's note under useHT=1; the card's times are in PERF.md
HT_NOTE = ("useHT=1 counts by 64-bit fingerprints with the same table as useHT=0; "
           "its time against useHT=0 on the card is in PERF.md")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastkmer_tpu_torch",
        description="Exact k-mer counting in PyTorch on CUDA (fastkmer-compatible CLI)",
    )
    p.add_argument("k", type=int)
    p.add_argument("m", type=int)
    p.add_argument("x", type=int)
    p.add_argument("B", type=int, help="max_b: bins = min(4^m, B)")
    p.add_argument("useHT", type=int, choices=(0, 1))
    p.add_argument("sequenceType", type=int, choices=(0, 1))
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("prefix")
    p.add_argument("write", type=int, choices=(0, 1))
    p.add_argument("enableKryo", type=int, choices=(0, 1),
                   help="1 = binary output (counts.npz)")
    p.add_argument("useCustomPartitioner", type=int, choices=(0, 1),
                   help="1 = LPT bin placement from a sampled pre-pass (--mesh); "
                        "recorded in the manifest")
    p.add_argument("numPartitionTasks", type=int, nargs="?", default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the extract kernel; cpu runs its plain version")
    p.add_argument("--reads-per-batch", type=int, default=512)
    p.add_argument("--read-len", type=int, default=4096)
    p.add_argument("--stats-json", default=None, help="write run summary JSON here")
    p.add_argument("--unique-ub", type=int, default=None,
                   help="asserted bound on distinct k-mers (e.g. genome length): "
                        "sync-free accumulator feed, verified at finalize")
    p.add_argument("--prededup", choices=("auto", "on", "off"), default="auto",
                   help="per-batch count+compact before accumulation (single "
                        "device), or the streaming mesh's dedup transport")
    p.add_argument("--mesh", type=int, default=1,
                   help="run over this many shards with the streaming counter "
                        "(or --smer-transport's per-batch job); 1 = single device")
    p.add_argument("--smer-transport", action="store_true",
                   help="ship super-k-mer records through the exchange instead of k-mers")
    p.add_argument("--checkpoint-dir", default=None,
                   help="enable kill-and-resume: persist partial tables here")
    p.add_argument("--checkpoint-interval", type=int, default=32,
                   help="batches between checkpoints")
    p.add_argument("--keep-table", action="store_true",
                   help="write a binary table.npz sidecar enabling zero-recount repair")
    p.add_argument("--trace-dir", default=None,
                   help="wrap the run in a torch.profiler trace written here")
    p.add_argument("--multiseq", action="store_true",
                   help="multisequence mode: per-(k-mer, sequence) counts and distances")
    p.add_argument("--distance-measure", default=DEFAULT_MEASURE,
                   help="the --multiseq distance (multiseq.distances.MEASURES)")
    return p


def _check_flags(args) -> None:
    """Every accepted flag takes effect on the selected path or raises (the
    JAX CLI's errors, in its order)."""
    if args.smer_transport and args.multiseq:
        raise NotImplementedError(
            "--smer-transport is a count-job mesh transport; the multiseq "
            "exchange ships (k-mer, seq) key lanes (no smer record format)"
        )
    if args.smer_transport and args.mesh <= 1:
        raise NotImplementedError(
            "--smer-transport selects the mesh exchange payload; use "
            "--mesh N (single-chip runs have no exchange)"
        )
    if not args.multiseq and args.distance_measure != DEFAULT_MEASURE:
        raise NotImplementedError("--distance-measure applies to --multiseq runs only")
    if args.multiseq and args.mesh <= 1 and args.prededup == "on":
        # single-device multiseq has no per-batch dedup step (the
        # accumulator takes raw (k-mer, seq) keys)
        raise NotImplementedError(
            "prededup is a mesh-transport / count-job feature; "
            "single-chip --multiseq has no dedup step"
        )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _check_flags(args)
    joined = args.mesh > 1 and _join_ranks(args)
    try:
        # one profiling hook around the whole job, as in the JAX CLI
        with maybe_profile(args.trace_dir):
            summary = _run_multiseq(args) if args.multiseq else _run(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(json.dumps(summary, indent=2))
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(summary, f, indent=2)
    return 0


def _join_ranks(args) -> bool:
    """Join the launcher's process group, if there is one: then --mesh is
    the global shard count and the rank's own paths get its rank.  Returns
    whether this call created the group."""
    import torch.distributed as dist

    from .parallel import multihost

    if dist.is_initialized():
        return False
    multihost.init_distributed(device=args.device)
    p = multihost.world_size()
    if p == 1:
        return False
    if args.mesh % p:
        dist.destroy_process_group()
        raise ValueError(f"--mesh {args.mesh} does not split over {p} ranks")
    r = multihost.rank()
    if args.stats_json:
        args.stats_json = f"{args.stats_json}.rank{r}"
    if args.checkpoint_dir:
        args.checkpoint_dir = os.path.join(args.checkpoint_dir, f"rank{r}")
    if args.trace_dir:
        args.trace_dir = os.path.join(args.trace_dir, f"rank{r}")
    return True


def _mesh(args):
    """The --mesh N shards: N/p on this rank over p ranks."""
    from .parallel import multihost

    return multihost.init_global_mesh(args.mesh // multihost.world_size(), args.device)


def _ranks(mesh) -> dict:
    """The summary's multi-rank fields: this rank, the world, the backend,
    how the exchange reaches the backend and the rank's collectives."""
    if mesh.world == 1:
        return {}
    c = mesh.comm
    return {"rank": mesh.rank, "world": mesh.world, "backend": c.backend,
            "exchange_staging": c.staging,
            "collectives": {"seconds": c.seconds, "calls": c.calls, "bytes": c.bytes}}


def _common(args) -> dict:
    return dict(
        dataset=args.input,
        output_directory=args.output,
        k=args.k,
        m=args.m,
        x=args.x,
        max_b=args.B,
        sequence_type=args.sequenceType,
        write=bool(args.write),
        use_kryo_serializer=bool(args.enableKryo),
        use_custom_partitioner=bool(args.useCustomPartitioner),
        num_partition_tasks=args.numPartitionTasks,
        prefix=args.prefix,
        reads_per_batch=args.reads_per_batch,
        read_len=args.read_len,
    )


def _run_multiseq(args) -> dict:
    """The multiseq job (useHT is not a field of its config, as in the JAX
    CLI) -> the run summary."""
    from .multiseq.pipeline import MultiseqConfig, execute_multiseq_job

    cfg = MultiseqConfig(**_common(args), distance_measure=args.distance_measure)
    prededup = {"auto": None, "on": True, "off": False}[args.prededup]
    if args.mesh > 1:
        from .multiseq.distributed import execute_multiseq_job_distributed

        mesh = _mesh(args)
        res = execute_multiseq_job_distributed(
            cfg, mesh, checkpoint_dir=args.checkpoint_dir,
            checkpoint_interval=args.checkpoint_interval, unique_ub=args.unique_ub,
            prededup=prededup, keep_table=args.keep_table,
        )
        extra = {"exchange_bytes": res.exchange_bytes, "balance": res.balance,
                 "placement": [str(d) for d in mesh.devices]}
    else:
        res = execute_multiseq_job(
            cfg, checkpoint_dir=args.checkpoint_dir,
            checkpoint_interval=args.checkpoint_interval, unique_ub=args.unique_ub,
            keep_table=args.keep_table, device=args.device,
        )
        extra = {"sync_free_feed": args.unique_ub is not None}
    return {
        "mode": "multiseq",
        "mesh": args.mesh,
        "device": args.device,
        "n_instances": res.n_instances,
        "n_unique_kmer_seq": int(res.words.shape[0]),
        "sequences": res.sequence_names,
        "n_distance_pairs": len(res.distances),
        "n_batches": res.n_batches,
        "output_dir": cfg.output_dir if cfg.write else None,
        "timings": res.timings,
        **extra,
    }


def _run(args) -> dict:
    """The count job -> the run summary."""
    cfg = JobConfig(**_common(args), use_ht=bool(args.useHT))
    prededup = {"auto": None, "on": True, "off": False}[args.prededup]
    if args.mesh > 1:
        from .parallel import driver

        mesh = _mesh(args)
        res = driver.execute_job_distributed(
            cfg, mesh, smer_transport=args.smer_transport,
            unique_ub=args.unique_ub, prededup=prededup,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_interval=args.checkpoint_interval, keep_table=args.keep_table,
        )
        extra = {
            "exchange_bytes": res.exchange_bytes,
            "exchange_cap": res.exchange_cap,
            "exchange_retries": res.exchange_retries,
            "balance": res.balance,
            "placement": [str(d) for d in mesh.devices],
            "n_dedup_batches": res.n_dedup_batches,
            **_ranks(mesh),
        }
    else:
        res = execute_job(cfg, unique_ub=args.unique_ub, prededup=prededup,
                          device=args.device, checkpoint_dir=args.checkpoint_dir,
                          checkpoint_interval=args.checkpoint_interval,
                          keep_table=args.keep_table)
        extra = {"spans": res.spans, "counters": res.counters}
    return {
        "mode": "count",
        "mesh": args.mesh,
        "engine": "hash" if cfg.use_ht else "sort",
        **({"engine_note": HT_NOTE} if cfg.use_ht else {}),
        "device": args.device,
        "n_instances": res.n_instances,
        "n_unique": int(res.words.shape[0]),
        "n_reads": res.n_reads,
        "n_bases": res.n_bases,
        "n_batches": res.n_batches,
        "output_dir": cfg.output_dir if cfg.write else None,
        "timings": res.timings,
        "sync_free_feed": args.unique_ub is not None,
        "prededup": args.prededup,
        **extra,
    }


if __name__ == "__main__":
    sys.exit(main())
