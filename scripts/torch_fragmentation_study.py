"""Root-cause study of tracker fragmentation on the PyTorch/CUDA port: the
counterpart of `scripts/fragmentation_study.py`.  Why does the tracker end
tracks that the float64 scipy oracle (`tests/torch_oracle_pipeline.py`)
keeps?

Both implement the same semantics, so an excess death must come from a
frame whose association is bistable: ALS entries near the 0.5
binarization edge, where the implementations' legitimate numeric freedoms
(f32 against f64, a fixed padded N with fixed rank and init against a
per-frame N and rank) pick different basins.  For the sequence:

  1. step it frame by frame, keeping every frame's PRE-step state
     (`debug.replay_states`, the tracker's own step on the device),
  2. align the tracker's deaths with the oracle's (within +-2 frames),
  3. for each death the oracle does not share, rebuild that frame's state
     from `TrackerState`'s own fields, apply the predict step, form the
     spatial-time similarity and re-solve it with the ALS kernel and its X
     output (`als_kernel.match_als(..., return_x=True)`, B1 on the card),
     measuring the dying track's support (matched views at the 0.5 cut),
     its margin (how far below 0.5 its best sub-threshold detection
     sits), and whether the oracle's float64 ALS on the same similarity
     (`als_f64_oracle_shaped`) keeps the track alive.

    python scripts/torch_fragmentation_study.py [--data_dir DIR] [--max_frames N] [--cpu]

`--data_dir` holds Shelf's layout (`kps_opn/`, `calibs/`); the default is
`data/shelf` inside the checkout, and a missing directory raises
`FileNotFoundError` (no other scene is put in its place).  The oracle's
tracklets are cached under `--oracle_cache` (default
`build/torch_oracle_cache/`), keyed by the directory, the frame count and
the input, and shared with `scripts/torch_oracle_parity_study.py`.  Runs
on the card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import numpy as np  # noqa: E402

from multiview_motion_capture_torch.bench import SHELF_DIR  # noqa: E402
from multiview_motion_capture_torch.cameras import CameraBank  # noqa: E402
from multiview_motion_capture_torch.config import PipelineConfig  # noqa: E402
from multiview_motion_capture_torch.data.ingest import (  # noqa: E402
    filter_bad_poses,
    load_openpose_dir,
)
from multiview_motion_capture_torch.debug import _als_with_x, _state_at, replay_states  # noqa: E402
from multiview_motion_capture_torch.tracker import (  # noqa: E402
    TrackerContext,
    _spatial_time_similarity,
    assemble_tracklets,
    predict,
)
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402
from torch_oracle_cache import oracle_module, run_oracle_cached  # noqa: E402

N_FRAMES = 300


def load_shelf(cfg, data_dir=SHELF_DIR, n_frames: int = N_FRAMES):
    """The sequence as `scripts/fragmentation_study.py:72-78` reads it:
    (filtered batch, cameras)."""
    data_dir = Path(data_dir)
    if not data_dir.is_dir():
        raise FileNotFoundError(f"no study data directory at {data_dir}")
    batch = load_openpose_dir(data_dir / "kps_opn", cfg, max_frames=n_frames)
    batch = filter_bad_poses(batch, cfg)
    cams = CameraBank.from_json_dir(data_dir / "calibs")
    return batch, cams


def oracle_tracklets(batch, cams, n_frames, data_dir, cache_dir=None):
    """The oracle's tracklets as (first frame, last frame, length) events."""
    tlets = run_oracle_cached(batch.kps, batch.valid, cams, n_frames, data_dir, cache_dir)
    return [(t.frames[0], t.frames[-1], len(t.frames)) for t in tlets]


def als_f64_oracle_shaped(sim, cfg):
    """The oracle's f64 ALS on the tracker's padded similarity matrix (same
    W, oracle numerics + group-zeroing): isolates numeric bistability."""
    T, V, P = cfg.max_tracks, cfg.n_views, cfg.max_people
    offsets = np.cumsum([0, T] + [P] * V)
    return oracle_module().match_als_np(sim.detach().cpu().numpy().astype(np.float64), offsets,
                        stable_iters=cfg.als_stable_iters or 10)


def align_deaths(deaths, o_events):
    """A tracker death at frame f is shared when the oracle also ends a
    tracklet within +-2 frames (fragment boundaries wobble by 1-2):
    (shared, excess) lists of (frame, slot)."""
    o_death_frames = sorted(e[1] + 1 for e in o_events)
    o_used = [False] * len(o_death_frames)
    shared, excess = [], []
    for f, t in deaths:
        hit = None
        for i, of in enumerate(o_death_frames):
            if not o_used[i] and abs(of - f) <= 2:
                hit = i
                break
        if hit is not None:
            o_used[hit] = True
            shared.append((f, t))
        else:
            excess.append((f, t))
    return shared, excess


def diagnose(ctx, pre_states, kps, valid, f: int, slot: int) -> dict:
    """Frame f's association re-run from its pre-step state, for the track
    in `slot` that died there."""
    import torch

    cfg = ctx.cfg
    dev = ctx.device
    state = predict(_state_at(pre_states, f, dev))
    kps_f = torch.as_tensor(kps[f], dtype=torch.float32, device=dev)
    valid_f = torch.as_tensor(valid[f], dtype=torch.bool, device=dev)
    sim, ev, _ = _spatial_time_similarity(ctx, state, kps_f, valid_f)
    res = _als_with_x(ctx, sim, ctx.diag_mask, ctx.init_A)
    X = res.x.cpu().numpy()
    xb = res.x_bin.cpu().numpy()
    T = cfg.max_tracks
    dv = ev.cpu().numpy()[T:]
    row = X[slot, T:]
    rowb = xb[slot, T:] & dv
    support = int(rowb.sum())
    # margin: the best sub-threshold detection entry (how close the track
    # came to keeping a second view)
    sub = row[dv & ~rowb]
    margin = float(0.5 - sub.max()) if sub.size else float("inf")
    xb64 = als_f64_oracle_shaped(sim, cfg)
    support64 = int((xb64[slot, T:] & dv).sum())
    return {
        "frame": int(f), "slot": int(slot),
        "support_f32": support, "margin_to_05": round(margin, 4),
        "support_f64_oracle_shape": support64,
        "f64_keeps_alive": bool(support64 >= 2),
    }


def main(argv=None, outputs: dict = None) -> dict:
    """The study's JSON object.  `outputs`: a dict that receives the
    replay's `outs` (numpy `FrameOutput`) and `tracklets`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", default=str(SHELF_DIR))
    ap.add_argument("--max_frames", type=int, default=N_FRAMES)
    ap.add_argument("--oracle_cache", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    # the parity-study config: rescue pinned OFF — this diagnoses the STRICT
    # reference-lifecycle deaths (rescue would erase exactly the deaths
    # being root-caused here)
    if not Path(args.data_dir).is_dir():
        raise FileNotFoundError(f"no study data directory at {args.data_dir}")
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = PipelineConfig(max_frames=args.max_frames, track_rescue_px=0.0)
    batch, cams = load_shelf(cfg, args.data_dir, args.max_frames)
    n = min(args.max_frames, batch.kps.shape[0])
    kps, valid = batch.kps[:n], batch.valid[:n]

    ctx = TrackerContext.build(cams, cfg, use_ik=True, device=dev)
    pre_states, outs = replay_states(ctx, kps, valid)
    tlets = assemble_tracklets(outs)
    print(f"tracker: {len(tlets)} tracklets", file=sys.stderr)
    if outputs is not None:
        outputs.update(outs=outs, tracklets=tlets)

    died = np.asarray(outs.died_track_id)  # (F, T)
    deaths = [(f, t) for f in range(n) for t in range(died.shape[1]) if died[f, t] >= 0]
    o_events = oracle_tracklets(batch, cams, n, args.data_dir, args.oracle_cache)
    print(f"oracle: {len(o_events)} tracklets; death frames "
          f"{sorted(e[1] + 1 for e in o_events)}", file=sys.stderr)
    shared, excess = align_deaths(deaths, o_events)
    print(f"tracker deaths: {len(deaths)} (shared {len(shared)}, "
          f"excess {len(excess)})", file=sys.stderr)

    diag = [diagnose(ctx, pre_states, kps, valid, f, slot) for f, slot in excess]
    n_flip = sum(d["f64_keeps_alive"] for d in diag)
    n_near = sum(d["margin_to_05"] < 0.1 for d in diag)
    out = {
        "tracker_tracklets": len(tlets),
        "oracle_tracklets": len(o_events),
        "tracker_deaths": len(deaths),
        "excess_deaths": len(excess),
        "excess_f64_would_keep": n_flip,
        "excess_margin_lt_0.1": n_near,
        "detail": diag,
    }
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
