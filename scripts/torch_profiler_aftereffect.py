#!/usr/bin/env python3
"""How a process's host code runs after it has traced with torch.profiler.

    python3 scripts/torch_profiler_aftereffect.py [--frames 40] [--rounds 2]

On the card: SHELF_BENCH's `pipeline.run` over the first `--frames` frames
of the smoke test's slice scene, `--rounds` times in a fresh process, then
`--rounds` times after one torch.profiler window (CUDA activity) in the
same process, then again after a window with CPU and CUDA activity.  Prints
one JSON line per run: its frames/s and the host time of one small CUDA
and one small CPU operation (20,000 calls each).  The path is host-bound,
so its frames/s reads the host's speed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profiler_aftereffect: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.config import SHELF_BENCH
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
    from multiview_motion_capture_torch.utils.precision import high_precision

    high_precision()
    cfg = dataclasses.replace(SHELF_BENCH, max_frames=None)
    seq = synthetic_sequence(cfg=cfg, n_frames=args.frames, n_people=4, n_views=5, seed=0)
    x, y = torch.zeros(16, device="cuda"), torch.zeros(16)

    def op_us(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20000):
            t.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 20000 * 1e6

    def measure(when):
        for r in range(args.rounds):
            res = pipeline.run(seq.batch, seq.cameras, cfg, device="cuda")
            print(json.dumps({"when": when, "round": r, "frames": res.n_frames,
                              "fps": res.fps, "cuda_op_us": op_us(x),
                              "cpu_op_us": op_us(y)}), flush=True)

    def trace(activities):
        with profile(activities=activities):
            for _ in range(20):
                x.add_(1.0)
            torch.cuda.synchronize()

    measure("fresh")
    trace([ProfilerActivity.CUDA])
    measure("after_cuda_trace")
    trace([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    measure("after_cpu_cuda_trace")
    return 0


if __name__ == "__main__":
    sys.exit(main())
