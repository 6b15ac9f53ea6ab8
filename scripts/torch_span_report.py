#!/usr/bin/env python3
"""Where a benchmark cell's frame goes, by the program's spans.

    python3 scripts/torch_span_report.py --workload <cell> --seed <n> --seconds <s> \
        --mode <off|spans|traced>

Runs one cell of `mocap_bench` (`BENCHMARK.json`) as `mocap_bench.run`
does, set-up, warm-up and a window of `--seconds`, without the judge:

- `off`: no spans are recorded (the benchmark's untraced run);
- `spans`: `profiling.recording()` from the process's top, no profiler:
  each span's count and self time a window frame, and `setup_s` split into
  the imports, the take, the context, the kernels' build or load, and the
  rest of the warm-up.  Against `off`, the cost of recording spans;
- `traced`: spans and a `torch.profiler` window (as `--trace 1`): each
  kernel put down to the span open on the host when its launch call ran
  (kineto's correlation id), each synchronising call to the span open when
  it ran, each device-idle gap to the span open at its midpoint.

Prints a table and, last, one JSON line.  Every span of the program is a
row; `(none)` is the host outside every span.  On one card only; the cells
step on one host thread, whose spans are the ones read.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

NONE = "(none)"
# per-layer readings, each the self time of its spans over the window's frames
SELF_MS = {
    "similarity_host_ms_per_frame": ("step.similarity",),
    "groups_host_ms_per_frame": ("step.merge", "step.groups"),
    "update_host_ms_per_frame": ("step.update",),
    "pose_host_ms_per_frame": ("step.pose",),
    "host_io_ms_per_frame": ("online.input", "online.output"),
}


def innermost(records: list, points: List[int]) -> list:
    """For each time in `points`, the innermost of `records` (the closed
    spans of one thread, which nest as calls nest) open then; None where
    none is."""
    recs = sorted(records, key=lambda r: (r.start_ns, -r.end_ns))
    order = sorted(range(len(points)), key=points.__getitem__)
    out: list = [None] * len(points)
    stack: list = []
    i = 0
    for k in order:
        t = points[k]
        while i < len(recs) and recs[i].start_ns <= t:
            while stack and stack[-1].end_ns < recs[i].start_ns:
                stack.pop()
            stack.append(recs[i])
            i += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def idle_gaps(busy: List[Tuple[int, int]], w0: int, w1: int) -> List[Tuple[int, int]]:
    """The window [w0, w1] less the device's busy spans (ascending and
    disjoint): the idle time `device_idle_pct` counts."""
    gaps, t = [], w0
    for s, e in busy:
        if e <= t:
            continue
        if s >= w1:
            break
        if s > t:
            gaps.append((t, s))
        t = e
    if t < w1:
        gaps.append((t, w1))
    return gaps


def span_rows(records: list, w0: int, w1: int) -> Dict[str, Dict[str, int]]:
    """Span name -> entries and self_ns of the `records` inside [w0, w1]."""
    rows: Dict[str, Dict[str, int]] = {}
    for r in records:
        if w0 <= r.start_ns and r.end_ns <= w1:
            row = rows.setdefault(r.name, {"entries": 0, "self_ns": 0})
            row["entries"] += 1
            row["self_ns"] += r.self_ns
    return rows


def attribute(records: list, w0: int, w1: int, kernels: List[Tuple[int, int, int]],
              launches: Dict[int, int], syncs: List[int],
              busy: List[Tuple[int, int]]) -> dict:
    """Put the window's work down to spans.  `records`: the stepping
    thread's closed spans; `kernels`: (correlation id, start ns, duration
    ns) of each kernel on the device; `launches`: correlation id -> host
    start ns of its runtime launch call; `syncs`: host start ns of each
    synchronising call; `busy`: the union of the device's busy spans.

    Returns `rows` (span name -> entries, self_ns, kernels, syncs, idle_ns
    over the window; entries and self time of the spans that open in it),
    `idle_ns` and `idle_outside_step_ns` (the gaps whose midpoint lies in
    no step), `unmatched` kernels (no launch call in the trace), and
    `kernels_checked` / `kernels_early`: kernels attributed inside a step
    and, of those, the ones that start before their step's start, with
    `early_max_ns`, the most by which one does.  An early kernel starts
    before its own launch call, which lies in the step: the profiler's
    device clock is then behind the host's, by as much as
    `before_launch_max_ns`, the most by which any kernel starts before its
    launch call (`before_launch` of them)."""
    rows: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"entries": 0, "self_ns": 0, "kernels": 0, "syncs": 0, "idle_ns": 0})
    for name, row in span_rows(records, w0, w1).items():
        rows[name].update(row)
    steps = {r.frame: r for r in records if r.name == "step"}

    in_window = [k for k in kernels if w0 <= k[1] <= w1]
    matched = [k for k in in_window if k[0] in launches]
    owners = innermost(records, [launches[k[0]] for k in matched])
    checked = early = early_max = 0
    for (_, start, _), rec in zip(matched, owners):
        rows[rec.name if rec else NONE]["kernels"] += 1
        if rec is not None and rec.frame is not None:
            checked += 1
            lead = steps[rec.frame].start_ns - start
            if lead > 0:
                early += 1
                early_max = max(early_max, lead)
    leads = [launches[c] - start for c, start, _ in matched if launches[c] > start]
    sync_in = [t for t in syncs if w0 <= t <= w1]
    for rec in innermost(records, sync_in):
        rows[rec.name if rec else NONE]["syncs"] += 1
    gaps = idle_gaps(busy, w0, w1)
    outside = 0
    for (a, b), rec in zip(gaps, innermost(records, [(a + b) // 2 for a, b in gaps])):
        rows[rec.name if rec else NONE]["idle_ns"] += b - a
        if rec is None or rec.frame is None:
            outside += b - a
    idle = sum(b - a for a, b in gaps)
    return {"rows": dict(rows), "idle_ns": idle, "idle_outside_step_ns": outside,
            "unmatched": len(in_window) - len(matched),
            "kernels_checked": checked, "kernels_early": early, "early_max_ns": early_max,
            "before_launch": len(leads), "before_launch_max_ns": max(leads, default=0)}


def readings(rows: Dict[str, dict], frames: int, idle_ns: Optional[int] = None,
             outside_ns: Optional[int] = None) -> Dict[str, float]:
    """The per-frame self-time readings of `SELF_MS` whose spans are there,
    and `idle_outside_step_pct` when the idle split is given."""
    out = {}
    for name, spans in SELF_MS.items():
        if frames and any(s in rows for s in spans):
            out[name] = sum(rows[s]["self_ns"] for s in spans if s in rows) / 1e6 / frames
    if idle_ns:
        out["idle_outside_step_pct"] = 100.0 * outside_ns / idle_ns
    return out


class Bounds:
    """The window's bounds on the spans' clock, and a profiler between
    them when `profile` is set (the harness's `Tracer`)."""

    def __init__(self, profile: bool):
        self.tracer = None
        if profile:
            from mocap_bench.trace import Tracer

            self.tracer = Tracer()

    def start(self):
        if self.tracer is not None:
            self.tracer.start()
        self.w0 = time.time_ns()

    def stop(self):
        self.w1 = time.time_ns()
        if self.tracer is not None:
            self.tracer.stop()


def _device_records(prof):
    """From a profiler's raw records: kernels (correlation id, start,
    duration), copies' spans, launch calls by correlation id, and the
    synchronising calls' starts."""
    import torch

    from mocap_bench.trace import SYNC_CALLS

    cuda = torch.autograd.DeviceType.CUDA
    kernels, copies, launches, syncs = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(("Memcpy", "Memset")):
                copies.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            else:
                kernels.append((e.correlation_id(), e.start_ns(), e.duration_ns()))
        elif name.startswith("cu"):
            if name in SYNC_CALLS:
                syncs.append(e.start_ns())
            if e.correlation_id():
                launches[e.correlation_id()] = e.start_ns()
    return kernels, copies, launches, syncs


def run(cell, seed: int, seconds: float, mode: str, device: str = "cuda",
        t_start: Optional[float] = None, overrides: Optional[dict] = None) -> dict:
    """One run of `cell` in `mode` (module docstring); `overrides` shrink
    the cell as `mocap_bench.run.run_cell`'s do."""
    import contextlib

    import torch

    from mocap_bench import drivers, scene, spec
    from mocap_bench.trace import _union
    from multiview_motion_capture_torch.cameras import CameraBank
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.utils import profiling

    t_start = T_START if t_start is None else t_start
    t_imports = time.perf_counter() - t_start
    dev = torch.device(device)
    spans = mode != "off"
    with profiling.recording() if spans else contextlib.nullcontext() as rec:
        pipeline, rig, traffic, scn = spec.merged(cell, overrides)
        cfg = PipelineConfig(**pipeline)
        cal = scene.camera_ring(rig)
        warm = int(traffic["warmup_frames"])
        n_take = warm + int(math.ceil(traffic["take_rate_fps"] * seconds))
        t0 = time.perf_counter()
        take = scene.make_take(cal, scn, cfg.max_people, n_take, seed, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_take = time.perf_counter() - t0
        cams = CameraBank.from_k_rt(cal.K, cal.Rt, cal.wh)
        drive = drivers.DRIVERS[traffic["mode"]](cams, cfg, traffic, take, dev)
        drive.warm_up(warm)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        bounds = Bounds(mode == "traced")
        res = drive.window(seconds, bounds)
        gc.unfreeze()
    frames = len(drive.outputs()[0]) - warm
    out = {"workload": cell.name, "seed": seed, "mode": mode, "frames": frames,
           "window_s": res["window_s"], "metrics": res["metrics"], "setup_s": setup_s,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if not spans:
        return out
    me = threading.get_native_id()
    records = [r for r in rec.closed() if r.thread == me]
    totals = rec.summary(records)
    setup = {"imports_s": t_imports, "take_s": t_take}
    for name in ("setup.context", "setup.kernels"):
        setup[name] = totals.get(name, {}).get("total_s")
    setup["rest_s"] = setup_s - t_imports - t_take - sum(
        v for k, v in setup.items() if k.startswith("setup.") and v)
    out["setup"] = setup
    w0, w1 = bounds.w0, bounds.w1
    steps = [r for r in records if r.name == "step" and w0 <= r.start_ns <= w1]
    out["steps"] = len(steps)
    if mode == "spans":
        rows = span_rows(records, w0, w1)
        out["rows"] = _per_frame(rows, frames)
        out["readings"] = readings(rows, frames)
        return out
    kernels, copies, launches, syncs = _device_records(bounds.tracer.prof)
    busy = _union([(s, s + d) for _, s, d in kernels] + copies)
    att = attribute(records, w0, w1, kernels, launches, syncs, busy)
    out["rows"] = _per_frame(att["rows"], frames)
    out["readings"] = readings(att["rows"], frames, att["idle_ns"], att["idle_outside_step_ns"])
    in_win = [k for k in kernels if w0 <= k[1] <= w1]
    out["trace"] = {"launches_per_frame": len(in_win) / frames,
                    "syncs_per_frame": sum(1 for t in syncs if w0 <= t <= w1) / frames,
                    "idle_pct": 100.0 * att["idle_ns"] / (w1 - w0),
                    **{k: att[k] for k in ("unmatched", "kernels_checked", "kernels_early",
                                           "early_max_ns", "before_launch",
                                           "before_launch_max_ns")}}
    return out


def _per_frame(rows: Dict[str, dict], frames: int) -> Dict[str, dict]:
    out = {}
    for name, row in sorted(rows.items(), key=lambda kv: -kv[1].get("self_ns", 0)):
        out[name] = {("self_ms" if k == "self_ns" else "idle_ms" if k == "idle_ns" else k):
                     (v / 1e6 if k.endswith("_ns") else v) / frames for k, v in row.items()}
    return out


def print_table(out: dict) -> None:
    rows = out.get("rows", {})
    if not rows:
        return
    cols = list(next(iter(rows.values())))
    print(f"{out['workload']} seed {out['seed']} {out['mode']}: {out['frames']} frames, "
          f"{out['steps']} steps; per window frame")
    print(f"{'span':<18}" + "".join(f"{c:>12}" for c in cols))
    for name, row in rows.items():
        print(f"{name:<18}" + "".join(f"{row[c]:>12.4f}" for c in cols))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--mode", choices=("off", "spans", "traced"), required=True)
    args = ap.parse_args(argv)

    import torch

    from mocap_bench import spec

    if not torch.cuda.is_available():
        print("torch_span_report: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out = run(spec.load_cell(args.workload), args.seed, args.seconds, args.mode)
    print_table(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
