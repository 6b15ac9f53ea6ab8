"""Scaled-rig benchmark of the PyTorch/CUDA port: 10 to 128 cameras x 10
people, association-only (triangulation mode) and full-IK frames/s on
synthetic sequences.  The counterpart of `scripts/bench_scaled.py`: the
same configurations, scenes, frame counts, two passes (the first untimed)
and JSON line.

Each configuration's association runs on the port's ALS kernels: one
matrix (B1, `csrc/als.cu`) up to N = 384, the camera clusters of the
wider rigs in one launch (B3); its LM on B2 (`ik_solver="gj"`) or B4
(`"gj_fused"`).  `kernel_launches` gives the launches of each of them in
the timed pass, read from `ops/cuda_lib`'s counters (0 on the CPU, where
the plain PyTorch versions run).

    python scripts/torch_bench_scaled.py [--cam128] [--ik-levers] [--cpu]

Runs on the card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multiview_motion_capture_torch.bench import backend_name  # noqa: E402
from multiview_motion_capture_torch.config import PipelineConfig  # noqa: E402
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence  # noqa: E402
from multiview_motion_capture_torch.eval import mpjpe_vs_ground_truth  # noqa: E402
from multiview_motion_capture_torch.ops import cuda_lib  # noqa: E402
from multiview_motion_capture_torch.tracker import (  # noqa: E402
    TrackerContext,
    assemble_tracklets,
    outputs_to_numpy,
    run_offline,
)
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402

# the kernels a configuration's tracker can launch: B1, B3, B2, B4
COUNTED = (cuda_lib.ALS, cuda_lib.ALS_BATCHED, cuda_lib.GJ_SOLVE, cuda_lib.FUSED_NORMAL_GJ)
MODES = ((False, "assoc_tri"), (True, "full_ik"))


def scaled_config(n_views, n_people, als_backend="auto", clusters=1, ik_max_views=None,
                  ik_solver="gj", **cfg_kw) -> PipelineConfig:
    """`scripts/bench_scaled.py`'s PipelineConfig for a rig (lines 39-45)."""
    return PipelineConfig(
        n_views=n_views, max_people=n_people, max_tracks=16,
        max_frames=None, als_max_iter=100, ik_warm_stages=1,
        ik_solver=ik_solver,
        als_backend=als_backend, assoc_clusters=clusters,
        ik_max_views=ik_max_views, **cfg_kw,
    )


def scaled_scene(cfg: PipelineConfig, n_people: int, n_frames: int):
    """The rig's synthetic sequence (`scripts/bench_scaled.py:46-48`)."""
    return synthetic_sequence(n_frames=n_frames, n_people=n_people, n_views=cfg.n_views,
                              cfg=cfg, seed=0, noise_px=1.0, drop_prob=0.05)


def _launches() -> dict:
    return {k.name: k.launches for k in COUNTED}


def bench_config(n_views, n_people, n_frames=200, als_backend="auto", clusters=1,
                 ik_max_views=None, ik_solver="gj", device="cuda", outputs=None,
                 **cfg_kw) -> dict:
    """One rig in both modes: per mode, frames/s of the second of two
    `run_offline` passes (the device synchronised), tracklets, those at
    least half the sequence long, their MPJPE against the ground truth
    (triangulation mode only), the timed pass's kernel launches and the
    association matrix's side.  `outputs`: a dict that receives each
    mode's per-frame outputs (numpy `FrameOutput`) by mode name."""
    dev = resolve_device(device)
    cfg = scaled_config(n_views, n_people, als_backend=als_backend, clusters=clusters,
                        ik_max_views=ik_max_views, ik_solver=ik_solver, **cfg_kw)
    seq = scaled_scene(cfg, n_people, n_frames)
    kps = torch.as_tensor(seq.batch.kps, device=dev)
    valid = torch.as_tensor(seq.batch.valid, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    for use_ik, name in MODES:
        ctx = TrackerContext.build(seq.cameras, cfg, use_ik=use_ik, device=dev)
        run_offline(ctx, kps, valid)            # warm: first use of each kernel
        sync()
        before = _launches()
        t0 = time.perf_counter()
        _, o = run_offline(ctx, kps, valid)
        sync()
        dt = time.perf_counter() - t0
        after = _launches()
        host = outputs_to_numpy(o)
        if outputs is not None:
            outputs[name] = host
        tlets = assemble_tracklets(host)
        long = [t for t in tlets if len(t) >= n_frames // 2]
        mpjpe = (mpjpe_vs_ground_truth(long, seq.gt_3d) if not use_ik else float("nan"))
        out[name] = {
            "fps": round(n_frames / dt, 1),
            "n_tracklets": len(tlets),
            "n_long": len(long),
            "mpjpe_m": None if np.isnan(mpjpe) else round(mpjpe, 4),
            "kernel_launches": {k: after[k] - before[k] for k in after},
            "n_matrix": cfg.n_matrix,
        }
    return out


def configs(cam128: bool = False, ik_levers: bool = False) -> dict:
    """`scripts/bench_scaled.py`'s configurations (lines 87-130): name ->
    bench_config's arguments."""
    wide = dict(clusters=2, ik_max_views=16)
    out = {
        "10cam_x_10ppl": dict(n_views=10, n_people=10),
        "20cam_x_10ppl": dict(n_views=20, n_people=10, n_frames=100),
        # N = 336: the widest single matrix
        "32cam_x_10ppl": dict(n_views=32, n_people=10, n_frames=60),
        # N = 16 + 640 = 656, past one matrix's 384: two interleaved clusters
        # of 32 cameras (N_c = 336 each) and the centroid merge
        "64cam_x_10ppl_2clusters": dict(n_views=64, n_people=10, n_frames=60, **wide),
    }
    if cam128:
        c4 = dict(n_views=128, n_people=10, n_frames=60, clusters=4, ik_max_views=16)
        out["128cam_x_10ppl_4clusters"] = c4
        # ceil(128 / 5) = 26 views a cluster, dead pad views: N_c = 276
        out["128cam_x_10ppl_5clusters_nondiv"] = dict(c4, clusters=5)
        out["128cam_x_10ppl_4clusters_levers"] = dict(c4, ik_cold_stages=1, ik_warm_iters=3)
        out["128cam_x_10ppl_4clusters_levers_cold25"] = dict(
            c4, ik_cold_stages=1, ik_warm_iters=3, ik_cold_iters=25)
    if ik_levers:
        w = dict(n_views=64, n_people=10, n_frames=60, **wide)
        out["64cam_coldstages1"] = dict(w, ik_cold_stages=1)
        out["64cam_coldstages1_loose"] = dict(w, ik_cold_stages=1, ik_ftol=1e-4, ik_xtol=1e-4)
        out["64cam_warmiters3"] = dict(w, ik_cold_stages=1, ik_warm_iters=3)
        out["64cam_gj_fused"] = dict(w, ik_solver="gj_fused")
        out["64cam_gj_fused_warm3_cold1"] = dict(w, ik_solver="gj_fused", ik_cold_stages=1,
                                                 ik_warm_iters=3)
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    dev = resolve_device(device)
    results = {}
    for name, kw in configs("--cam128" in argv, "--ik-levers" in argv).items():
        t0 = time.perf_counter()
        results[name] = bench_config(device=dev, **kw)
        print(f"{name}: {results[name]} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
              flush=True)
    line = {
        "metric": "scaled_rig_fps",
        "value": results["10cam_x_10ppl"]["full_ik"]["fps"],
        "unit": "frames/s",
        "extra": {**results, "backend": backend_name(dev)},
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
