#!/usr/bin/env python3
"""Time the port's ALS kernels (B1 one problem, B3 batched) on one GPU.

    python scripts/torch_als_timing.py [--root DIR] [--cases b1_frame0,b3_wide64]

Imports `multiview_motion_capture_torch` from the checkout at DIR (default:
the one holding this script), builds its kernels, and times each case by
CUDA events (median over rounds of the mean of back-to-back launches):

- `b1_frame0`: one SHELF_BENCH problem (N = 38, rank 16), the spatial-only
  similarity of the first frame of the 5-camera synthetic scene;
- `b1_default`: the default preset's problem on that frame (N = 66, rank
  32, one block, to its own count under the 1,000-iteration cap);
- `b3_wide64`: the two camera clusters of `PipelineConfig.wide(64)` (N =
  336, rank 32) on the first frame of the 64-camera scene;
- `b1_n336`: the first of those two problems alone (B1 as one cluster of
  16 blocks, the benchmark's `rig32` shape);
- `b3_rig128`: the four camera clusters of `PipelineConfig.wide(128,
  assoc_clusters=4)` (N = 336, rank 32) on the first frame of the
  128-camera scene (the benchmark's `dome128` shape).

Each runs the ALS to its stop test or its configuration's cap.  It prints one
JSON line: the card's `nvidia-smi` name and power limit, and per case the
ms per launch, the iteration counts, the ms per iteration of the longest
problem and a digest of x_bin (equal across checkouts whose kernels are
bit-equal).  To compare two checkouts, run it for each in turns on one
card, one command after another (parent, change, change, parent).  Needs a
GPU.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path


def _time_ms(torch, fn, reps: int, rounds: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _frame0_problems(torch, cfg, n_views: int, n_people: int, **scene):
    """The spatial-only similarity of each camera cluster on frame 0."""
    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    seq = synthetic_sequence(n_frames=1, n_people=n_people, n_views=n_views, seed=0,
                             cfg=cfg, **scene)
    b = filter_bad_poses(seq.batch, cfg)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device="cuda")
    kps = torch.as_tensor(b.kps[0], device="cuda")
    valid = torch.as_tensor(b.valid[0], device="cuda")
    if cfg.assoc_clusters == 1:
        W, _ = tracker._spatial_similarity(ctx, kps, valid)
        return W.contiguous(), ctx.diag_mask, ctx.init_A
    W = torch.stack([tracker._spatial_similarity(ctx, kps, valid, view_idx=cl.views,
                                                 view_valid=cl.view_valid)[0]
                     for cl in ctx.clusters]).contiguous()
    return W, ctx.cluster_diag_mask, ctx.cluster_init_A


def case_problems(torch, case: str):
    """(cfg, W, mask, init) of a named case; W is (C, N, N) for B3 and (N, N)
    for B1."""
    from multiview_motion_capture_torch.config import SHELF_BENCH, PipelineConfig

    if case == "b1_frame0":
        return (SHELF_BENCH, *_frame0_problems(torch, SHELF_BENCH, 5, 4))
    if case == "b1_default":
        cfg = PipelineConfig(n_views=5, max_frames=None)
        return (cfg, *_frame0_problems(torch, cfg, 5, 4))
    if case in ("b3_wide64", "b1_n336"):
        cfg = PipelineConfig.wide(64, max_frames=None)
        W, mask, init = _frame0_problems(torch, cfg, 64, 10, noise_px=1.0, drop_prob=0.05)
        return (cfg, W[0].contiguous() if case == "b1_n336" else W, mask, init)
    if case == "b3_rig128":
        cfg = PipelineConfig.wide(128, assoc_clusters=4, max_frames=None)
        return (cfg, *_frame0_problems(torch, cfg, 128, 10, noise_px=1.0, drop_prob=0.05))
    raise SystemExit(f"unknown case {case}")


def _als_args(cfg) -> dict:
    """The ALS settings the tracker passes (tracker._run_als)."""
    return dict(alpha=cfg.als_alpha, beta=cfg.als_beta, mu0=cfg.als_mu, tol=cfg.als_tol,
                max_iter=cfg.als_max_iter, stable_iters=cfg.als_stable_iters)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--cases", default="b1_frame0,b3_wide64")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("torch_als_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multiview_motion_capture_torch.ops import als_kernel, cuda_lib

    cuda_lib.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"root": args.root, "nvidia_smi": smi.splitlines()[0], "cases": {}}
    for case in args.cases.split(","):
        cfg, W, mask, init = case_problems(torch, case)
        solve = als_kernel.match_als if W.dim() == 2 else als_kernel.match_als_batched

        def call():
            return solve(W, mask, init, **_als_args(cfg))

        res = call()
        iters = [int(i) for i in res.n_iters.reshape(-1).tolist()]
        ms = _time_ms(torch, call, args.reps, args.rounds)
        out["cases"][case] = {
            "shape": list(W.shape), "rank": int(init.shape[1]), "ms": ms, "iters": iters,
            "ms_per_iter": ms / max(iters),
            "x_bin_digest": hashlib.sha1(res.x_bin.cpu().numpy().tobytes()).hexdigest()[:12]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
