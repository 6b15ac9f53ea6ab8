"""The traced run's device trace, reduced in memory to what the per-layer
metrics read.

`Tracer` holds a `torch.profiler` session (host and CUDA activities) over
the measured window.  `summarise` reads the profiler's raw records (its own
parse takes seconds for every ~20,000 events, and a window holds millions)
and keeps: the device's kernels and copies, each with its span; the host's
synchronising runtime calls; and, for the breakdown, what the host was
doing in each idle gap of the device.  Nothing is written to disk.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
TOP = 10


@dataclass
class TraceSummary:
    """What one traced window holds.  `frames`: the frames tracked in it;
    `window_s`: its length on the host clock; `kernels`: (name, start_ns,
    dur_ns) of each kernel; `copies`: the same of each copy and memset;
    `syncs`: synchronising runtime calls; `counters`: the program's own
    counts over the window (`als_iters`, the sum of `FrameOutput.als_iters`),
    and the ALS problem's shape (`als_n`, `als_rank`, `als_problems`)."""

    frames: int
    window_s: float
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)
    copies: List[Tuple[str, int, int]] = field(default_factory=list)
    syncs: int = 0
    busy_s: float = 0.0
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, substring: str) -> float:
        return sum(d for name, _, d in self.kernels if substring in name) / 1e9

    def kernel_count(self, substring: str = "") -> int:
        return sum(1 for name, _, _ in self.kernels if substring in name)


class Tracer:
    """A profiler session over the window; `stop()` ends it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()

    def stop(self):
        self.prof.stop()


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:64]


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_at(points: List[int], host: List[Tuple[int, int, str]]) -> List[str]:
    """For each time in `points` (ascending), the innermost host operation
    running then ("host between operators" where none is): a sweep over the
    host's spans of one thread, which nest as calls nest."""
    names = []
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else "host between operators")
    return names


def summarise(tracer: Tracer, frames: int, window_s: float,
              counters: Optional[Dict[str, float]] = None) -> TraceSummary:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, copies, host_by_thread = [], [], defaultdict(list)
    syncs = 0
    for e in tracer.prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            rec = (name, e.start_ns(), e.duration_ns())
            (copies if name.startswith(("Memcpy", "Memset")) else kernels).append(rec)
        else:
            if name in SYNC_CALLS:
                syncs += 1
            host_by_thread[e.start_thread_id()].append((e.start_ns(), e.end_ns(), name))
    s = TraceSummary(frames=frames, window_s=window_s, kernels=kernels, copies=copies,
                     syncs=syncs, counters=dict(counters or {}))
    busy = _union([(st, st + d) for _, st, d in kernels + copies])
    s.busy_s = sum(e - b for b, e in busy) / 1e9
    by_name: Dict[str, int] = defaultdict(int)
    for name, _, d in kernels + copies:
        by_name[name] += d
    s.device_ops = [[_short(n), d / 1e9] for n, d in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    # idle gaps between the device's busy spans, named by the host's work
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)
            if busy[k + 1][0] > busy[k][1]]
    if gaps and host_by_thread:
        # parents before the children that start with them
        host = sorted(max(host_by_thread.values(), key=len), key=lambda h: (h[0], -h[1]))
        mids = [(a + b) // 2 for a, b in gaps]
        order = sorted(range(len(gaps)), key=mids.__getitem__)
        names = _host_at([mids[k] for k in order], host)
        idle: Dict[str, int] = defaultdict(int)
        for k, name in zip(order, names):
            idle[name] += gaps[k][1] - gaps[k][0]
        s.idle_gaps = [[_short(n), d / 1e9] for n, d in
                       sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]
    return s

