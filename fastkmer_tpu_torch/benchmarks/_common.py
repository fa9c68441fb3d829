"""What every probe of the port shares: one JSON line per measure, logs on
stderr, the device fence, the slope timing and CUDA-event timing."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA's data sheet)


def emit(**fields) -> dict:
    """Print ``fields`` as one JSON line on stdout; returns them."""
    print(json.dumps(fields), flush=True)
    return fields


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_name(dev: torch.device) -> str:
    """The card's name, or "cpu": every measure says where it was taken."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def fence(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_iters(fn, args: tuple, iters: int, dev: torch.device) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    fence(dev)
    return time.perf_counter() - t0


def slope(fn, args: tuple, dev: torch.device, iters: int = 10, warmup: int = 2):
    """Marginal seconds a call, (T(2I) - T(I)) / I by the host clock, each
    run fenced: constant overheads (the fence, the first launch) cancel and
    builds land in the warm-up.  Returns (marginal, naive = T(I) / I)."""
    for _ in range(warmup):
        fn(*args)
    fence(dev)
    t_lo = _run_iters(fn, args, iters, dev)
    t_hi = _run_iters(fn, args, 2 * iters, dev)
    return (t_hi - t_lo) / iters, t_lo / iters


BUSY_CYCLES = 2_000_000  # about a millisecond of the card's clock


def time_ms(fn, iters: int, setup=None) -> float:
    """Median milliseconds of ``fn`` on the current card by CUDA events,
    after one warm-up call; ``setup`` runs before each call, outside the
    timed span.  A spin kernel of ``BUSY_CYCLES`` keeps the card busy while
    the host queues the events and ``fn``'s launches, so the span holds the
    device's time and not the host's time to launch."""
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if setup is not None:
            setup()
        torch.cuda._sleep(BUSY_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rand_i32(gen: torch.Generator, n: int, dev: torch.device, lo: int = -(1 << 31),
             hi: int = 1 << 31) -> torch.Tensor:
    """n int32 values uniform in [lo, hi), made on ``dev`` from ``gen``
    (a generator of that device); the full default range is every uint32 bit
    pattern."""
    return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int64).to(
        torch.int32)
