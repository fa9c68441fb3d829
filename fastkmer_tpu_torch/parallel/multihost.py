"""Multi-process meshes on ``torch.distributed`` — the port of
``fastkmer_tpu.parallel.multihost``.

The JAX package scales past one host with a multi-process pod slice in
which every process runs the same program and jax stitches the global
device mesh.  Here every rank of a ``torch.distributed`` group runs the
same job; its ``exchange.Mesh`` holds the rank's own shards, and global
shard ``rank * n_local + j`` is its j-th (JAX's process-major device
order):

    # torchrun --nproc-per-node 2 -m fastkmer_tpu_torch.cli ... --mesh 4
    # or RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT set by hand
    from fastkmer_tpu_torch.parallel import multihost
    multihost.init_distributed()                  # reads the launcher's env
    mesh = multihost.init_global_mesh(2)          # 2 shards on this rank's cards
    res = driver.execute_job_distributed(cfg, mesh)   # this rank's bins

A rank's shards spread over the cards its host gives it (``local_cards``:
local rank r of q on the host owns the cards c with c % q == r; a rank
more than the cards shares one), and rank 0 warns when a host card gets
no shard.  Under torchrun the host's ranks come from ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE``; a hand launch without them counts them through the
rendezvous store, each rank writing its hostname there.

Every rank reads the whole file and feeds its round-robin stripe of
batches, padded so that every rank takes the same number of steps
(``stripe_batches_padded``).  The collectives are ``Collectives``' methods:
the cross-rank exchange (``all_to_all``), the sums and maxima that every
host decision reads, ``agree_min`` and ``barrier``.

Backend rule (stated, never a fallback): ``nccl`` when every rank has a
card of its own; ``gloo`` when ranks share a card (NCCL refuses two ranks
on one device) or run on the CPU.  An explicit ``backend="nccl"`` where
that cannot work raises.  Under gloo the exchange hands CUDA tensors to
``all_to_all_single`` when this build's gloo accepts them (probed once by
``init_global_mesh``), and otherwise stages them through pinned host
buffers; counting, sorting and merging stay on the card either way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import bits

# seconds a collective may wait for the other ranks before it raises: a
# rank that falls out of step fails the job instead of hanging it
DEFAULT_TIMEOUT_S = 120.0


def choose_backend(device: torch.device, local_ranks: int, n_cards: int) -> str:
    """The backend rule: gloo on the CPU; on CUDA, nccl when the ranks of
    this host have a card each, else gloo (NCCL refuses two ranks on one
    device)."""
    if device.type == "cpu":
        return "gloo"
    return "nccl" if local_ranks <= n_cards else "gloo"


def local_cards(local_rank: int, local_ranks: int, n_cards: int) -> tuple[int, ...]:
    """The cards of local rank ``local_rank`` of ``local_ranks`` on a host
    of ``n_cards``: those c with c % local_ranks == local_rank, so the
    host's ranks partition its cards; with more ranks than cards, the one
    card local_rank % n_cards.  Local shard j sits on cards[j % len(cards)]."""
    if local_ranks > n_cards:
        return (local_rank % n_cards,)
    return tuple(range(local_rank, n_cards, local_ranks))


def idle_cards(local_ranks: int, n_local: int, n_cards: int) -> int:
    """The cards of a host that get no shard when each of its
    ``local_ranks`` ranks holds ``n_local`` shards placed by local_cards."""
    used = sum(min(n_local, len(local_cards(r, local_ranks, n_cards)))
               for r in range(min(local_ranks, n_cards)))
    return n_cards - used


def host_layout(hostnames: list, rank: int) -> tuple[int, int]:
    """(local rank, ranks on this host) from every rank's hostname: the
    ranks on one host are numbered in global rank order."""
    same = [r for r, h in enumerate(hostnames) if h == hostnames[rank]]
    return same.index(rank), len(same)


# (the default group init_distributed started, local rank, ranks on this
# host); read through host_position, which ignores the layout of a group
# that has since been destroyed
_layout: tuple[object, int, int] | None = None


def host_position() -> tuple[int, int] | None:
    """(local rank, ranks on this host) of this process when
    ``init_distributed`` started the live default group, else None (no
    group, or one started by other means after that group was destroyed)."""
    if _layout is None or not dist.is_initialized() or _layout[0] is not dist.group.WORLD:
        return None
    return _layout[1], _layout[2]


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` for this rank.

    With all of the first three None it reads the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``: torchrun's), the counterpart of
    JAX's auto-detection; with no such environment it stays a single
    process.  ``coordinator_address`` is ``host:port``.  ``backend`` None
    applies the backend rule for ``device``; every collective of the group
    raises after ``timeout_s`` seconds of waiting.  Prints the backend and
    why on rank 0.  A no-op once the group exists."""
    if dist.is_initialized():
        return
    global _layout
    dev = torch.device(device)
    if coordinator_address is None:
        world = _env_int("WORLD_SIZE")
        rank = _env_int("RANK")
        if world is None or rank is None:
            return  # no launcher: one process
        init_method = "env://"
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    else:
        world, rank = num_processes, process_id
        if world is None or rank is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        host, port = coordinator_address.rsplit(":", 1)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and n_cards == 0:
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
    if backend == "nccl" and dev.type == "cpu":
        raise ValueError("backend nccl cannot serve device cpu: NCCL needs a card per rank; "
                         "use gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = None
    local_ranks = _env_int("LOCAL_WORLD_SIZE")
    if local_ranks is not None:  # torchrun's layout
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    else:
        # a hand launch: count this host's ranks through the rendezvous
        # store before the backend rule reads them
        if host is None or port is None:
            raise ValueError("a launch without LOCAL_WORLD_SIZE needs MASTER_ADDR and "
                             "MASTER_PORT, or coordinator_address")
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)
        store.set(f"fastkmer/hostname/{rank}", socket.gethostname())
        names = [store.get(f"fastkmer/hostname/{r}").decode() for r in range(world)]
        local_rank, local_ranks = host_layout(names, rank)
    rule = choose_backend(dev, local_ranks, n_cards)
    if backend is None:
        backend = rule
    elif backend == "nccl" and rule != "nccl":
        raise ValueError(
            f"backend nccl cannot serve {local_ranks} ranks on {n_cards} card(s) of "
            f"device {dev.type}: NCCL needs a card per rank; use gloo"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(local_cards(local_rank, local_ranks, n_cards)[0])
    rendezvous = {"init_method": init_method} if store is None else {"store": store}
    dist.init_process_group(backend, world_size=world, rank=rank, timeout=timeout, **rendezvous)
    _layout = (dist.group.WORLD, local_rank, local_ranks)
    if rank == 0:
        why = ("CPU tensors" if dev.type == "cpu" else
               f"{local_ranks} ranks on {n_cards} card(s): "
               + ("one card each" if backend == "nccl" else "NCCL refuses two ranks on one card"))
        print(f"[multihost] {world} ranks, backend {backend} ({why}), collective timeout "
              f"{timeout_s:g} s", file=sys.stderr, flush=True)


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass
class Collectives:
    """The collectives of a multi-rank mesh, on the default process group,
    and what they cost this rank: ``seconds`` of wall time inside them
    (device copies to and from the staging buffers included), ``calls``,
    and ``bytes`` sent to other ranks by the exchange."""

    backend: str
    device: torch.device  # the rank's first card (its current device), or the CPU
    staging: str  # "direct": tensors go to the backend as they are; "host": pinned copies
    seconds: float = 0.0
    calls: int = 0
    bytes: int = 0

    @contextlib.contextmanager
    def _timed(self):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Block q of ``send`` (its first dimension has one entry per
        rank) goes to rank q; block q of the result came from rank q."""
        p = send.shape[0]
        with self._timed():
            wire = send.contiguous()
            if self.staging == "host" and wire.device.type == "cuda":
                wire = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True).copy_(wire)
            out = torch.empty_like(wire)
            dist.all_to_all_single(out, wire)
            out = out.to(send.device)
        self.bytes += send.numel() * send.element_size() * (p - 1) // p
        return out

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise sum, max or min of ``t`` over the ranks, on t's
        device (nccl reduces on the card, gloo on the host)."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
        with self._timed():
            wire = t.to(self.device if self.backend == "nccl" else "cpu", copy=True)
            dist.all_reduce(wire, op=red)
            out = wire.to(t.device)
        return out

    def barrier(self, name: str = "fastkmer") -> None:
        """Every rank reaches this point before any leaves it (``name``
        labels the wait in an error)."""
        try:
            self.reduce(torch.zeros(1, dtype=torch.int64))
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r}: {e}") from e


def _gloo_takes_cuda(dev: torch.device) -> bool:
    """Whether this build's gloo runs all_to_all_single on CUDA tensors
    (every rank probes together, and gloo refuses a device type before any
    rank communicates)."""
    x = torch.zeros(world_size(), dtype=torch.int32, device=dev)
    try:
        dist.all_to_all_single(torch.empty_like(x), x)
    except RuntimeError:
        return False
    return True


def warn_idle_cards(local_ranks: int, n_local: int, n_cards: int) -> None:
    """One line on stderr when a host's cards are not all given a shard."""
    idle = idle_cards(local_ranks, n_local, n_cards)
    if idle > 0:
        print(f"[multihost] warning: {idle} of this host's {n_cards} cards get no shard "
              f"({local_ranks} rank(s) of {n_local} shard(s) each); give each rank more "
              f"shards or the host more ranks", file=sys.stderr, flush=True)


def init_global_mesh(local_shards: int | None = None, device="cuda"):
    """The global 1-D mesh: ``local_shards`` shards on each rank, spread
    over the rank's cards (``local_cards``) or all on the CPU.  Without a
    process group of several ranks it is ``exchange.make_mesh`` (default:
    one shard per visible card).  Rank 0 warns when cards of its host get
    no shard.  Runs on the card unless the caller asks for the CPU; raises
    when CUDA is asked for and absent."""
    from ..pipeline import resolve_device
    from . import exchange

    dev = resolve_device(device)
    p = world_size()
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if p == 1:
        if local_shards is None:
            local_shards = n_cards if dev.type == "cuda" else 1
        if dev.type == "cuda":
            warn_idle_cards(1, local_shards, n_cards)
        return exchange.make_mesh(local_shards, dev)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type == "cpu":
        raise ValueError("an nccl group cannot run a CPU mesh; initialize with device='cpu'")
    n_local = 1 if local_shards is None else int(local_shards)
    r = rank()
    devices = (dev,) * n_local
    if dev.type == "cuda":
        layout = host_position()
        if layout is None:  # a group that init_distributed did not start
            cards = (torch.cuda.current_device(),)
        else:
            cards = local_cards(*layout, n_cards)
            if r == 0:
                warn_idle_cards(layout[1], n_local, n_cards)
        devices = tuple(torch.device("cuda", cards[j % len(cards)]) for j in range(n_local))
        dev = devices[0]
    staging = "direct"
    if backend == "gloo" and dev.type == "cuda" and not _gloo_takes_cuda(dev):
        staging = "host"
    comm = Collectives(backend, dev, staging)
    lo, hi = (comm.reduce(torch.tensor([n_local]), op)[0].item() for op in ("min", "max"))
    if lo != hi or n_local < 1:
        raise ValueError(f"ranks hold {lo} to {hi} shards; every rank needs the same count >= 1")
    if r == 0 and dev.type == "cuda" and backend == "gloo":
        print(f"[multihost] gloo all_to_all_single on CUDA tensors: "
              f"{'accepted' if staging == 'direct' else 'refused; staged through pinned host buffers'}",
              file=sys.stderr, flush=True)
    return exchange.Mesh(devices, rank=r, world=p, comm=comm)


def agree_min(value: int, comm: Collectives | None = None) -> int:
    """The minimum of a per-rank host integer over the ranks.  Re-aligns
    checkpoint cursors on resume: a crash can land between the ranks'
    cursor writes, and resuming from cursors that disagree would put the
    collective feed out of step."""
    if world_size() == 1:
        return value
    comm = comm or Collectives(dist.get_backend(), _default_device(), "direct")
    return int(comm.reduce(torch.tensor([value], dtype=torch.int64), "min")[0])


def barrier(name: str = "fastkmer", comm: Collectives | None = None) -> None:
    """Cross-rank sync point (a no-op in one process)."""
    if world_size() == 1:
        return
    (comm or Collectives(dist.get_backend(), _default_device(), "direct")).barrier(name)


def _default_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_stripe(n_items: int, n_hosts: int | None = None,
                host_id: int | None = None) -> tuple[int, int]:
    """[start, end) of a globally indexed input owned by this rank."""
    p = n_hosts if n_hosts is not None else world_size()
    i = host_id if host_id is not None else rank()
    per = -(-n_items // p)
    return min(i * per, n_items), min((i + 1) * per, n_items)


def stripe_batches(batches, n_hosts: int | None = None, host_id: int | None = None):
    """Round-robin batch assignment across ranks for a stream of unknown
    length."""
    p = n_hosts if n_hosts is not None else world_size()
    i = host_id if host_id is not None else rank()
    for j, b in enumerate(batches):
        if j % p == i:
            yield b


def stripe_batches_padded(batches, rows: int, length: int, n_hosts: int | None = None,
                          host_id: int | None = None):
    """``stripe_batches`` padded so that every rank feeds the same number
    of steps, ceil(total batches / p): the step is a collective, so the
    ranks must stay in lockstep.  A rank whose stripe ran out a batch early
    feeds an all-invalid one.  Yields (codes [rows, length], n_reads,
    n_bases) like the batchers."""
    p = n_hosts if n_hosts is not None else world_size()
    i = host_id if host_id is not None else rank()
    total = mine = 0
    for j, b in enumerate(batches):
        total += 1
        if j % p == i:
            mine += 1
            yield b
    for _ in range(-(-total // p) - mine):
        yield np.full((rows, length), bits.INVALID_CODE, dtype=np.uint8), 0, 0
