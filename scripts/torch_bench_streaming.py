"""Streaming (online) benchmark of the PyTorch/CUDA port: throughput and
latency of `MvTracker.update_batch` against the chunk size k.  The
counterpart of `scripts/bench_streaming.py`: the same sequence (Shelf,
SHELF_BENCH at 300 frames, the bad-pose filter), k in {1, 4, 8, 16, 32},
a warm chunk and then the state reset in place, and the same JSON line.

A chunk of k frames comes to the host once; a frame waits for its chunk,
so an online user trades k - 1 frames of buffering for fewer round trips.

    python scripts/torch_bench_streaming.py [--data_dir DIR] [--max_frames N] [--cpu]

`--data_dir` holds `kps_opn/` (OpenPose JSON, one sub-directory per
camera) and `calibs/` (one calibration JSON per camera); the default is
the Shelf directory of the `bench` mode.  A missing directory raises
`FileNotFoundError`.  Runs on the card unless `--cpu` is given; without a
GPU it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from multiview_motion_capture_torch.bench import SHELF_DIR, backend_name  # noqa: E402
from multiview_motion_capture_torch.cameras import CameraBank  # noqa: E402
from multiview_motion_capture_torch.config import SHELF_BENCH  # noqa: E402
from multiview_motion_capture_torch.data.ingest import (  # noqa: E402
    filter_bad_poses,
    load_openpose_dir,
)
from multiview_motion_capture_torch.tracker import MvTracker, TrackerState  # noqa: E402
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402

KS = (1, 4, 8, 16, 32)


def load(data_dir, max_frames: int = 300):
    """The sequence as `scripts/bench_streaming.py:35-40` reads it: (cfg,
    filtered batch, cameras)."""
    data_dir = Path(data_dir)
    if not data_dir.is_dir():
        raise FileNotFoundError(f"no benchmark data directory at {data_dir}")
    cfg = dataclasses.replace(SHELF_BENCH, max_frames=max_frames)
    batch = filter_bad_poses(load_openpose_dir(data_dir / "kps_opn", cfg), cfg)
    cams = CameraBank.from_json_dir(data_dir / "calibs")
    return cfg, batch, cams


def stream_curve(cams, cfg, kps, valid, ks=KS, device="cuda", trackers=None) -> dict:
    """For each k: a tracker warmed on one chunk of k frames (all F when
    fewer), its state reset
    in place, then the F frames in chunks of k (`pad_to=k`: the tail chunk
    is short); frames/s over the whole stream, the p50 and p99 ms of one
    `update_batch` call, and the tracklets.  `trackers`: a dict that
    receives each k's tracker (its `outputs` are the stream's frames)."""
    dev = resolve_device(device)
    F = kps.shape[0]
    results = {}
    for k in ks:
        tracker = MvTracker(cams, cfg, use_ik=True, device=dev)
        w = min(k, F)
        tracker.update_batch(list(range(w)), kps[:w], valid[:w])
        tracker.state = TrackerState.zeros(cfg, device=tracker.ctx.device)
        tracker.outputs.clear()
        tracker.frame_idxs.clear()

        lat = []
        t0 = time.perf_counter()
        n_done = 0
        for s in range(0, F, k):
            e = min(F, s + k)
            ts = time.perf_counter()
            # update_batch returns once the chunk's outputs are on the host
            tracker.update_batch(list(range(s, e)), kps[s:e], valid[s:e], pad_to=k)
            lat.append(time.perf_counter() - ts)
            n_done += e - s
        total = time.perf_counter() - t0
        lat_ms = np.asarray(lat) * 1e3
        results[f"k={k}"] = {
            "fps": round(n_done / total, 1),
            "dispatch_ms_p50": round(float(np.percentile(lat_ms, 50)), 1),
            "dispatch_ms_p99": round(float(np.percentile(lat_ms, 99)), 1),
            "n_tracklets": len(tracker.tracklets()),
        }
        if trackers is not None:
            trackers[k] = tracker
        print(f"k={k}: {results[f'k={k}']}", file=sys.stderr, flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", default=str(SHELF_DIR))
    ap.add_argument("--max_frames", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    cfg, batch, cams = load(args.data_dir, args.max_frames)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    F = min(args.max_frames, batch.n_frames)
    results = stream_curve(cams, cfg, batch.kps[:F], batch.valid[:F], device=dev)
    best = max(results.values(), key=lambda r: r["fps"])
    line = {
        "metric": "shelf_streaming_fps",
        "value": best["fps"],
        "unit": "frames/s",
        "extra": {**results, "backend": backend_name(dev)},
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
