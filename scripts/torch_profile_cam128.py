"""Profile the PyTorch/CUDA port on the 128-camera full-IK configuration
and print the top kernels by device time.

The counterpart of `scripts/profile_cam128.py`: 128 views, 10 people,
`max_tracks=16`, the ALS capped at 100 iterations, one warm LM stage, the
cameras in 4 association clusters (the batched ALS kernel B3,
`csrc/als.cu`, one launch a frame), at most 16 views a track in the LM,
on `synthetic_sequence(60 frames, noise 1 px, drop 0.05, seed 0)`.  The
config keeps the default LM solver, `"chol"` (a Cholesky library call in
both packages), so no LM solve kernel runs.  It attributes the frame's
time between the global (N = 1,296)^2 stages (closure products, centroid
merge, rescue masks) and the per-cluster solvers.  `--levers` adds the
IK levers (`ik_cold_stages=1`, `ik_warm_iters=3`); `--assoc-only` runs
triangulation mode.

The passes and the report are `scripts/torch_profile_bench.py`'s
(`profile_tracker`, `print_report`): a warm pass, a synchronised steady
pass, a device-only traced pass (`--trace-host` adds the host), the top
45 kernels with their counts, launches a frame and the idle share of both
passes.

    python scripts/torch_profile_cam128.py [trace_dir] [--assoc-only]
        [--levers] [--trace-host] [--cpu]

Runs on the card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from torch_profile_bench import print_report, profile_tracker  # noqa: E402

N_FRAMES = 60


def cam128_config(levers: bool = False):
    """`scripts/profile_cam128.py`'s PipelineConfig (lines 35-41)."""
    from multiview_motion_capture_torch.config import PipelineConfig

    extra = {"ik_cold_stages": 1, "ik_warm_iters": 3} if levers else {}
    return PipelineConfig(
        n_views=128, max_people=10, max_tracks=16, max_frames=None,
        als_max_iter=100, ik_warm_stages=1, assoc_clusters=4,
        ik_max_views=16, **extra,
    )


def main(argv=None) -> dict:
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
    from multiview_motion_capture_torch.tracker import TrackerContext
    from multiview_motion_capture_torch.utils.precision import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir", nargs="?", default=None)
    ap.add_argument("--assoc-only", action="store_true")
    ap.add_argument("--levers", action="store_true")
    ap.add_argument("--trace-host", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    use_ik = not args.assoc_only
    cfg = cam128_config(args.levers)
    seq = synthetic_sequence(n_frames=N_FRAMES, n_people=10, n_views=128, cfg=cfg,
                             seed=0, noise_px=1.0, drop_prob=0.05)
    kps = torch.as_tensor(seq.batch.kps, device=dev)
    valid = torch.as_tensor(seq.batch.valid, device=dev)
    ctx = TrackerContext.build(seq.cameras, cfg, use_ik=use_ik, device=dev)
    rep = profile_tracker(ctx, kps, valid, N_FRAMES, trace_host=args.trace_host,
                          trace_dir=args.trace_dir, label=f" (use_ik={use_ik})")
    rep["use_ik"] = use_ik
    rep["levers"] = args.levers
    print_report(rep)
    return rep


if __name__ == "__main__":
    main()
