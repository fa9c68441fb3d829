"""One whole job under ``torch.profiler``, and what the trace says.

The device's busy time is the union of the intervals of the rows that ran
on the card (kernels, copies, fills), as ``tools/profile_port.py`` takes it;
its idle gaps are the holes in that union inside the job, each named by
the innermost host operator the profiler recorded at the gap's start.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

JOB_SPAN = "kbench.job"
TOP = 10


class Profile(NamedTuple):
    wall_s: float  # the job's wall time on the host clock
    job: tuple  # (start, end) of the job in the trace's microseconds
    device: list  # (start, end, name) of every row on the card
    host: list  # (start, end, name) of every host operator


def profile_job(run_job) -> Profile:
    """Run ``run_job()`` once under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(JOB_SPAN):
            t0 = time.perf_counter()
            run_job()
            wall = time.perf_counter() - t0
    device, host, job = [], [], None
    for e in prof.events():
        row = (e.time_range.start, e.time_range.end, e.name)
        if e.name == JOB_SPAN:
            if e.device_type == DeviceType.CPU:
                job = row[:2]
        elif e.device_type == DeviceType.CUDA:
            device.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    return Profile(wall, job, device, host)


def merged(intervals) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint pairs."""
    out = []
    for a, b, *_ in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(p: Profile) -> float:
    return sum(b - a for a, b in merged(p.device)) / 1e6


def top_device_ops(p: Profile) -> list:
    """[[name, seconds], ...]: the device rows that took most time."""
    by = collections.Counter()
    for a, b, name in p.device:
        by[name] += b - a
    return [[name, us / 1e6] for name, us in by.most_common(TOP)]


def _host_op_at(p: Profile, t: float) -> str:
    inner = None
    for a, b, name in p.host:
        if a <= t < b and (inner is None or a >= inner[0]):
            inner = (a, name)
    return inner[1] if inner else "host (no profiled op)"


def idle_gaps(p: Profile) -> list:
    """[[name, seconds], ...]: the longest holes in the device's busy
    union inside the job."""
    if p.job is None:
        return []
    start, end = p.job
    gaps, t = [], start
    for a, b in merged(p.device):
        if a > t:
            gaps.append((a - t, t))
        t = max(t, b)
    if end > t:
        gaps.append((end - t, t))
    gaps.sort(reverse=True)
    return [[_host_op_at(p, at), us / 1e6] for us, at in gaps[:TOP]]
