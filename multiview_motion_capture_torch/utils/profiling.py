"""Per-stage timing and optional profiler traces.

Port of `multiview_motion_capture_tpu/utils/profiling.py`: the reference
only has commented-out `time.time()` spans (ref:src/mv_math_util.py:
326-346, ref:src/mv_association.py:274,314); here every run returns a
structured dict of stage seconds (`pipeline.RunResult.timings`).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch

from multiview_motion_capture_torch.utils.precision import resolve_device


class StageTimer:
    """Wall seconds and call counts per named stage.  With a CUDA `device`,
    each stage ends with `torch.cuda.synchronize`, so its time holds the
    device work it queued."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
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
