"""Profile the PyTorch/CUDA port's Shelf benchmark path in the steady state
and print the top kernels by device time.

The counterpart of `scripts/profile_bench.py`: SHELF_BENCH at 300 frames
(`load_openpose_dir` -> `filter_bad_poses` -> `CameraBank.from_json_dir`),
`run_offline` on the card (ALS kernel B1 `csrc/als.cu`, LM solve kernel B2
`csrc/gj_solve.cu`): a warm pass, a synchronised steady pass (`steady-state:
... fps`), then one pass under `torch.profiler`.  The report is the JAX
program's table with CUDA kernels in place of XLA ops: the total kernel time,
then the top 45 kernels by device time with their counts (the B-kernels
named by their kernel-table entries).  Beside it: launches a frame and the
device's idle share of both passes, 1 - kernel time / wall time (the steady
pass is not profiled, so its idle share carries no profiler overhead).

The device only is traced unless `--trace-host` is given: the path launches
~3,200 kernels a frame, and a host trace of 300 frames holds millions of
events.  `trace_dir` (optional) receives the trace as `trace.json`
(Chrome's format).

    python scripts/torch_profile_bench.py [trace_dir] [--data_dir DIR]
        [--max_frames 300] [--trace-host] [--cpu]

`--data_dir` is the Shelf dataset's layout (`kps_opn/camNN/*.json`,
`calibs/camNN.json`), by default `data/shelf` in the checkout; a missing
directory raises FileNotFoundError (no synthetic scene is put in its
place).  Runs on the card unless `--cpu` is given (then the "device" is the
host, and the table holds the host operators' own times); without a GPU it
raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

N_TOP = 45
# each hand-written kernel's device function -> its kernel-table entries
B_KERNELS = {"fused_normal_gj_kernel": "B4 fused normal-equation solve (csrc/fused_normal_gj.cu)",
             "gj_solve_kernel": "B2/B5 Gauss-Jordan solve (csrc/gj_solve.cu)",
             "als_kernel": "B1/B3 ALS (csrc/als.cu)"}


def kernel_label(name: str) -> str:
    """A hand-written kernel's kernel-table entry in place of its long
    demangled name; any other name as it is."""
    for fn, label in B_KERNELS.items():
        if fn in name:
            return label
    return name


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def b_launches() -> dict:
    """The hand-written kernels' launch counters, by kernel-table name."""
    from multiview_motion_capture_torch.ops import cuda_lib

    return {k.name: k.launches for k in cuda_lib.ALL_KERNELS}


def trace(run, dev: torch.device, trace_host: bool = False, trace_dir=None):
    """`run()` once under torch.profiler, the device synchronised at its
    end: the card's kernels, and the host's operations when `trace_host`
    (on the CPU the host is the device, so it is always traced).  Returns
    (profiler, wall seconds, run's result)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    activities = ([ProfilerActivity.CPU] if trace_host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = run()
        _sync(dev)
        wall_s = time.perf_counter() - t0
    if trace_dir is not None:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
    return prof, wall_s, out


# the profiler's own records, which its parse (`prof.events()`,
# `key_averages()`) leaves out too
SKIPPED = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
           "profiler::_record_function_enter_new", "profiler::_record_function_exit",
           "aten::is_leaf", "aten::output_nr", "aten::_version"}


def _self_ns(spans) -> list:
    """Each host operator's own time: its span less its direct children's
    (spans (start, end) of one thread, nested as calls nest)."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][0], -spans[i][1]))
    own = [end - start for start, end in spans]
    stack = []
    for i in order:
        start, end = spans[i]
        while stack and spans[stack[-1]][1] <= start:
            stack.pop()
        if stack:
            own[stack[-1]] -= min(end, spans[stack[-1]][1]) - start
        stack.append(i)
    return own


def device_events(prof, dev: torch.device) -> list:
    """(name, ns) of each of the device's events in a trace, read from the
    profiler's raw records (its own parse takes seconds for every ~20,000
    events, and a CPU trace of 3 SHELF_BENCH frames holds ~345,000): on a
    CUDA device the card's kernels and copies, each its duration; on the
    CPU the host's operators, each its own time, one a record (an operator
    that calls itself again, as aten::eye does, gives one a level, where
    the profiler's parse folds them into one call)."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() not in SKIPPED and not e.is_hidden_event()]
    if dev.type == "cuda":
        return [(e.name(), e.duration_ns()) for e in evs
                if e.device_type() == torch.autograd.DeviceType.CUDA]
    by_thread = defaultdict(list)
    for e in evs:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            by_thread[e.start_thread_id()].append(e)
    out = []
    for thread in by_thread.values():
        own = _self_ns([(e.start_ns(), e.end_ns()) for e in thread])
        out.extend((e.name(), ns) for e, ns in zip(thread, own))
    return out


def kernel_report(prof, dev: torch.device, wall_s: float, n_frames: int,
                  steady_wall_s=None, launches=None, n_top: int = N_TOP) -> dict:
    """The device's work in a traced pass: `rows` (name, ms, count) of the
    top `n_top` kernels by device time, `total_ms`, launches and busy ms a
    frame, and the idle share 1 - busy / wall of the traced pass and, given
    the unprofiled `steady_wall_s` of the same work, of that pass.  On a CUDA
    device the rows are the kernels the profiler saw on the card (one
    stream, so their times add up); on the CPU the host operators' own
    times.  `launches`: the hand-written kernels' launch counts in the
    traced pass."""
    by_name = defaultdict(lambda: [0.0, 0])
    events = device_events(prof, dev)
    for name, ns in events:
        acc = by_name[kernel_label(name)]
        acc[0] += ns / 1e6
        acc[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    rows = [{"name": name, "ms": ms, "count": n}
            for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]]
    wall_ms = wall_s * 1e3
    rep = {"device": str(dev), "frames": n_frames, "total_ms": busy_ms,
           "wall_ms_per_frame": wall_ms / n_frames,
           "device_busy_ms_per_frame": busy_ms / n_frames if events else None,
           "launches_per_frame": len(events) / n_frames if events else None,
           "idle_share": 1.0 - busy_ms / wall_ms if events else None,
           "rows": rows}
    if steady_wall_s is not None:
        rep["steady_wall_ms_per_frame"] = steady_wall_s * 1e3 / n_frames
        rep["idle_share_unprofiled"] = (1.0 - busy_ms / (steady_wall_s * 1e3)
                                        if events else None)
    if launches is not None:
        rep["b_kernel_launches"] = launches
    return rep


def print_report(rep: dict) -> None:
    """The JAX program's table (total, then `ms  count x  name` a kernel),
    then launches and idle shares, then the report as one JSON line."""
    dev = torch.device(rep["device"])
    where = (f"{rep['device']} ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else f"{rep['device']} (host operators' self time)")
    print(f"\n== device {where}: total kernel time {rep['total_ms'] / 1e3:.3f}s "
          f"over {rep['frames']} frames ==")
    for r in rep["rows"]:
        print(f"{r['ms']:9.1f} ms {r['count']:8d}x  {r['name'][:110]}")
    print(f"launches a frame: {rep['launches_per_frame']}; idle share: traced pass "
          f"{rep['idle_share']}, unprofiled pass {rep.get('idle_share_unprofiled')}")
    print(json.dumps({k: v for k, v in rep.items() if k not in ("rows", "outputs")}),
          flush=True)


def profile_tracker(ctx, kps, valid, n_frames: int, steady: bool = True,
                    trace_host: bool = False, trace_dir=None, n_top: int = N_TOP,
                    label: str = "") -> dict:
    """`run_offline(ctx, kps, valid)`: a warm pass, then (with `steady`) a
    synchronised pass timed on the host clock, then a traced pass; returns
    the report (`kernel_report`) with `outputs` (numpy `FrameOutput`s of the
    steady pass, or of the warm pass, and of the traced pass)."""
    from multiview_motion_capture_torch.tracker import outputs_to_numpy, run_offline

    dev = ctx.device
    _, out = run_offline(ctx, kps, valid)
    _sync(dev)
    steady_s = None
    if steady:
        t0 = time.perf_counter()
        _, out = run_offline(ctx, kps, valid)
        _sync(dev)
        steady_s = time.perf_counter() - t0
        print(f"steady-state: {steady_s:.3f}s = {n_frames / steady_s:.1f} fps{label}")
    first = outputs_to_numpy(out)
    before = b_launches()
    prof, wall_s, (_, traced) = trace(lambda: run_offline(ctx, kps, valid), dev,
                                      trace_host, trace_dir)
    launches = {k: v - before[k] for k, v in b_launches().items()}
    rep = kernel_report(prof, dev, wall_s, n_frames, steady_s, launches, n_top)
    rep["outputs"] = (first, outputs_to_numpy(traced))
    return rep


def load(data_dir: Path, max_frames: int = 300):
    """SHELF_BENCH at `max_frames` on `data_dir`'s sequence: (cfg, the
    filtered FrameBatch cut to `max_frames`, cameras)."""
    from multiview_motion_capture_torch.cameras import CameraBank
    from multiview_motion_capture_torch.config import SHELF_BENCH
    from multiview_motion_capture_torch.data.ingest import (
        FrameBatch,
        filter_bad_poses,
        load_openpose_dir,
    )

    data_dir = Path(data_dir)
    if not data_dir.is_dir():
        raise FileNotFoundError(f"no Shelf data directory at {data_dir}")
    cfg = dataclasses.replace(SHELF_BENCH, max_frames=max_frames)
    batch = filter_bad_poses(load_openpose_dir(data_dir / "kps_opn", cfg), cfg)
    batch = FrameBatch(kps=batch.kps[:max_frames], valid=batch.valid[:max_frames])
    return cfg, batch, CameraBank.from_json_dir(data_dir / "calibs")


def main(argv=None) -> dict:
    from multiview_motion_capture_torch.bench import SHELF_DIR
    from multiview_motion_capture_torch.tracker import TrackerContext
    from multiview_motion_capture_torch.utils.precision import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir", nargs="?", default=None)
    ap.add_argument("--data_dir", default=str(SHELF_DIR))
    ap.add_argument("--max_frames", type=int, default=300)
    ap.add_argument("--trace-host", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    cfg, batch, cams = load(Path(args.data_dir), args.max_frames)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    kps = torch.as_tensor(batch.kps, device=dev)
    valid = torch.as_tensor(batch.valid, device=dev)
    ctx = TrackerContext.build(cams, cfg, use_ik=True, device=dev)
    rep = profile_tracker(ctx, kps, valid, kps.shape[0], trace_host=args.trace_host,
                          trace_dir=args.trace_dir)
    print_report(rep)
    return rep


if __name__ == "__main__":
    main()
