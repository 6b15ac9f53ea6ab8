"""Run one cell of the benchmark of `multiview_motion_capture_torch` once.

    python3 -m mocap_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for
(it exits with code 2 and prints no result without them; nothing falls
back to the CPU).  Set-up, counted in `setup_s` from the process's start:
the imports, the rig and the take made from the seed on the card, the
tracker's context (the port's kernels are built on a checkout's first run
into its `build/torch_kernels/` and loaded from there after), and warm-up:
the take's first frames tracked through the cell's own path.  Then the
window of `--seconds`: the take goes on through `tracker.run_offline` in
chunks (offline traffic) or frame by frame through `MvTracker.update`
(online traffic).  With `--trace 1` a profiler traces the window and the
per-layer metrics are read from its records; without, the end-to-end
metrics are taken on the host clock.  After the window the outputs are
judged against the plain reference (`check.py`).

The last line of standard output is the result; an earlier line holds the
program's counts.  The last lines of standard error give each number
compared with its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches of compiled code at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
FORBIDDEN = ("jax", "jaxlib", "flax", "multiview_motion_capture_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None, overrides: dict = None) -> dict:
    """Set up, warm up, measure and judge one run of `cell`.  `overrides`
    (`pipeline`, `rig`, `scene`, `traffic` dicts merged into the cell's
    files) shrink a cell for a rehearsal on the CPU; the command line never
    gives any.  Returns the result line's fields and the counts line's."""
    import numpy as np
    import torch

    from mocap_bench import check, drivers, reference, scene, spec
    from mocap_bench.trace import Tracer, summarise
    from multiview_motion_capture_torch.cameras import CameraBank
    from multiview_motion_capture_torch.config import PipelineConfig

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    pipeline, rig, traffic, scn = spec.merged(cell, overrides)
    cfg = PipelineConfig(**pipeline)
    cal = scene.camera_ring(rig)
    warm = int(traffic["warmup_frames"])
    n_take = warm + int(math.ceil(traffic["take_rate_fps"] * seconds))
    take = scene.make_take(cal, scn, cfg.max_people, n_take, seed, dev)
    cams = CameraBank.from_k_rt(cal.K, cal.Rt, cal.wh)
    drive = drivers.DRIVERS[traffic["mode"]](cams, cfg, traffic, take, dev)
    drive.warm_up(warm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    tracer = Tracer() if trace else None
    res = drive.window(seconds, tracer)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    gc.unfreeze()

    outs, frame_ids = drive.outputs()
    window_idx = list(range(warm, len(outs)))
    iters = np.array([int(outs[i]["als_iters"]) for i in window_idx])
    Vc = -(-cfg.n_views // cfg.assoc_clusters)
    counts = {"frames": len(window_idx), "window_s": res["window_s"],
              "take_frames": n_take, "take_starts": res["take_starts"],
              "warmup_frames": warm, "als_iters_per_frame": float(iters.mean()),
              "setup_s": setup_s}
    summary = None
    if trace:
        summary = summarise(tracer, len(window_idx), res["window_s"], counters={
            "als_iters": float(iters.sum()), "als_n": cfg.max_tracks + Vc * cfg.max_people,
            "als_rank": cfg.als_max_rank, "als_problems": cfg.assoc_clusters})
        tracer = None
    failed = sum(1 for i in window_idx
                 if not np.isfinite(outs[i]["pose3d"][outs[i]["updated"]]).all())
    drive.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the judge: the take's first frame and a sample of the window's
    rc = reference.RefContext(cal.K, cal.Rt, pipeline, device=dev)
    judged = sorted(set([0] + check.sample(window_idx, int(traffic["check_frames"]), seed)))
    kps_np, valid_np = take.kps.cpu().numpy(), take.valid.cpu().numpy()
    del take
    t_judge = time.perf_counter()
    numbers = check.judge(rc, kps_np, valid_np, frame_ids, outs, judged)
    numbers["judge_s"] = time.perf_counter() - t_judge
    limits = cell.limits["limits"]
    correct = check.verdict(numbers, limits)

    if trace:
        wanted = cell.per_layer
        values = {m.name: spec.reader(m.name)(summary) for m in wanted}
    else:
        wanted = cell.end_to_end
        values = {**res["metrics"], "setup_s": setup_s}
    metrics = {m.name: {"value": values[m.name], "unit": m.unit}
               for m in wanted if values.get(m.name) is not None}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak}
    line = {"correct": bool(correct), "attempted": len(window_idx), "failed": failed,
            "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
        counts["trace"] = {"kernels": len(summary.kernels), "syncs": summary.syncs}
    line["checks"] = {name: {"value": numbers[name], "limit": lim}
                      for name, lim in limits.items()}
    return {"line": line, "counts": counts, "numbers": numbers}


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from mocap_bench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}, which the benchmark of the port may not load",
              file=sys.stderr)
        return 3
    line = out["line"]
    line["device"]["power_limit_w"] = power_limit_w()
    print(json.dumps({"counts": out["counts"], "numbers": out["numbers"]}), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {json.dumps(c['limit'])}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
