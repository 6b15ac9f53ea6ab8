"""Per-stage timing, the program's spans and optional profiler traces.

Port of `multiview_motion_capture_tpu/utils/profiling.py`: the reference
only has commented-out `time.time()` spans (ref:src/mv_math_util.py:
326-346, ref:src/mv_association.py:274,314); here every run returns a
structured dict of stage seconds (`pipeline.RunResult.timings`).

Spans name the layers of the tracker's per-frame step (`span`), recorded
only inside `recording()`.  Each record is stamped with `time.time_ns()`,
the clock on which `torch.profiler` (kineto) stamps its host and device
events, so a trace's kernels, synchronising calls and device-idle gaps can
be put down to the span the host was in.  Outside a recording `span`
returns one shared no-op context: no allocation, no sync, no device work.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

from multiview_motion_capture_torch.utils.precision import resolve_device

# the active recording; None when spans are off (the default)
_RECORDER: Optional["SpanRecorder"] = None
_NOOP = contextlib.nullcontext()


class SpanRecord:
    """One span: its name, host-clock bounds (`time.time_ns()`), the span
    open around it on its thread (`parent`, None at a root), the thread
    (`threading.get_native_id()`), the sequence number of the frame whose
    step it lies in (`frame`, None outside a step) and the time its
    children cover (`child_ns`)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "frame", "child_ns")

    def __init__(self, name: str, start_ns: int, parent: Optional["SpanRecord"],
                 thread: int, frame: Optional[int]):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.parent = parent
        self.thread = thread
        self.frame = frame
        self.child_ns = 0

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        """The duration less the part the span's children cover."""
        return self.duration_ns - self.child_ns


class _Span:
    __slots__ = ("recorder", "name", "new_frame", "record")

    def __init__(self, recorder: "SpanRecorder", name: str, new_frame: bool):
        self.recorder, self.name, self.new_frame = recorder, name, new_frame

    def __enter__(self):
        self.record = self.recorder._open(self.name, self.new_frame)
        return self.record

    def __exit__(self, *exc):
        self.recorder._close(self.record)
        return False


class SpanRecorder:
    """The spans of one recording, kept in memory in the order they
    opened.  Each thread has its own stack of open spans, so spans of two
    threads never parent each other."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self._local = threading.local()
        self._frames = itertools.count()

    def _open(self, name: str, new_frame: bool) -> SpanRecord:
        local = self._local
        try:
            stack = local.stack
        except AttributeError:
            # once a thread: get_native_id is a system call
            stack = local.stack = []
            local.thread = threading.get_native_id()
        parent = stack[-1] if stack else None
        frame = next(self._frames) if new_frame else (parent.frame if parent else None)
        rec = SpanRecord(name, time.time_ns(), parent, local.thread, frame)
        stack.append(rec)
        self.records.append(rec)
        return rec

    def _close(self, rec: SpanRecord) -> None:
        rec.end_ns = time.time_ns()
        self._local.stack.pop()
        if rec.parent is not None:
            rec.parent.child_ns += rec.duration_ns

    def closed(self) -> List[SpanRecord]:
        return [r for r in self.records if r.end_ns is not None]

    def summary(self, records: Optional[List[SpanRecord]] = None) -> Dict[str, Dict[str, float]]:
        """Per span name: `count`, `total_s` and `self_s` over `records`
        (default: every closed span)."""
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "total_s": 0.0, "self_s": 0.0})
        for r in self.closed() if records is None else records:
            s = out[r.name]
            s["count"] += 1
            s["total_s"] += r.duration_ns / 1e9
            s["self_s"] += r.self_ns / 1e9
        return dict(out)


def span(name: str, frame: bool = False):
    """A context around one layer's work, recorded while `recording()` is
    on.  `frame=True` marks one frame's step: it takes the next sequence
    number, which every span under it carries."""
    rec = _RECORDER
    if rec is None:
        return _NOOP
    return _Span(rec, name, frame)


@contextlib.contextmanager
def recording():
    """Record spans (`span`) while the block runs; yields the
    `SpanRecorder`, whose records are read after the block."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("spans are already being recorded")
    rec = SpanRecorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None


class StageTimer:
    """Wall seconds and call counts per named stage.  With a CUDA `device`,
    each stage ends with `torch.cuda.synchronize`, so its time holds the
    device work it queued.  Each stage is also a span of its name."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.device is not None and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._totals[name] += time.perf_counter() - t0
                self._counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self._totals)

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device="cuda"):
    """Trace a block with `torch.profiler` when `log_dir` is set (None: no
    trace): host activity, and the card's kernels on a CUDA `device`.  The
    Chrome trace goes to `log_dir/trace.json`."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(out / "trace.json"))
